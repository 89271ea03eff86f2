"""Minimal RIFF/WAVE reader+writer (PCM 16/24/32-bit and IEEE float32); a
copy of the JAX package's ``io/wav.py``.

Standalone (no external deps) so fixtures and the CLI work everywhere; the
reference consumes live PipeWire audio, the rebuild's offline API consumes
files or arrays.
"""

from __future__ import annotations

import struct

import numpy as np


def read_wav(path: str) -> tuple[np.ndarray, float]:
    """Returns ``(samples [frames, channels] float32, sample_rate)``."""
    with open(path, "rb") as f:
        riff, _size, wave_tag = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave_tag != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        fmt_payload = b""
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            tag, size = struct.unpack("<4sI", hdr)
            payload = f.read(size)
            if size % 2:
                f.read(1)
            if tag == b"fmt ":
                fmt = struct.unpack("<HHIIHH", payload[:16])
                fmt_payload = payload  # keep full chunk for the extensible subformat
            elif tag == b"data":
                data = payload
        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")
        audio_format, channels, rate, _byte_rate, _block_align, bits = fmt
        if audio_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE: subformat GUID's
            # first two bytes (at offset 24 of the fmt chunk) are the real tag
            if len(fmt_payload) >= 26:
                audio_format = struct.unpack("<H", fmt_payload[24:26])[0]
            else:
                raise ValueError(f"{path}: truncated extensible fmt chunk")
        if audio_format == 3 and bits == 32:
            x = np.frombuffer(data, "<f4").astype(np.float32)
        elif audio_format == 1 and bits == 16:
            x = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
        elif audio_format == 1 and bits == 32:
            x = np.frombuffer(data, "<i4").astype(np.float32) / 2147483648.0
        elif audio_format == 1 and bits == 24:
            raw = np.frombuffer(data, np.uint8).reshape(-1, 3)
            as32 = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            as32 = np.where(as32 >= 1 << 23, as32 - (1 << 24), as32)
            x = as32.astype(np.float32) / float(1 << 23)
        else:
            raise ValueError(f"{path}: unsupported format {audio_format}/{bits}bit")
        frames = len(x) // channels
        return x[: frames * channels].reshape(frames, channels), float(rate)


def write_wav(path: str, samples: np.ndarray, sample_rate: float) -> None:
    """Writes ``[frames, channels]`` float32 as IEEE-float WAV."""
    samples = np.asarray(samples, np.float32)
    if samples.ndim == 1:
        samples = samples[:, None]
    frames, channels = samples.shape
    data = samples.astype("<f4").tobytes()
    byte_rate = int(sample_rate) * channels * 4
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 36 + len(data), b"WAVE"))
        f.write(
            struct.pack(
                "<4sIHHIIHH", b"fmt ", 16, 3, channels, int(sample_rate),
                byte_rate, channels * 4, 32,
            )
        )
        f.write(struct.pack("<4sI", b"data", len(data)))
        f.write(data)

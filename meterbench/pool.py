"""The traffic's audio: a pool of programme-like stereo clips made from the
seed, and which clip and offset each stream reads.

Each clip is a run of sections 1.5 to 8 s long: one to three tones (40 Hz
to 8 kHz), noise (white, or low-passed at about 1 kHz), or both.  Each
section's level steps 6 to 20 dB up or down from the last, within -40 to
-8 dBFS RMS; about one section in six sits at -85 to -78 dBFS, below the
-70 LUFS absolute gate.  The right channel is the left one's tones at
another gain plus noise of its own.  The section plan comes from a numpy
generator and the samples from a ``torch.Generator`` on the device, in a
few calls a section; the pool then moves to the host once, where the
producer and the reference both read it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

RATE = 48_000.0


def _rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**64 - 1), salt])


def make_pool(seed: int, clips: int, clip_seconds: float, device) -> np.ndarray:
    """``[clips, clip_frames, 2]`` float32 on the host."""
    n = int(round(clip_seconds * RATE))
    rng = _rng(seed, 1)
    gen = torch.Generator(device=device).manual_seed(int(seed) & (2**63 - 1))
    out = torch.empty((clips, n, 2), dtype=torch.float32, device=device)
    a = math.exp(-2 * math.pi * 1000.0 / RATE)
    for c in range(clips):
        pos, level = 0, rng.uniform(-30.0, -15.0)
        while pos < n:
            m = min(int(rng.uniform(1.5, 8.0) * RATE), n - pos)
            t = (pos + torch.arange(m, device=device, dtype=torch.float64)) / RATE
            kind = rng.integers(3)  # tones, noise, both
            sec = torch.zeros((m, 2), dtype=torch.float64, device=device)
            if kind != 1:
                for _ in range(rng.integers(1, 4)):
                    f = math.exp(rng.uniform(math.log(40.0), math.log(8000.0)))
                    tone = torch.sin(2 * math.pi * f * t + rng.uniform(0, 2 * math.pi))
                    gains = torch.as_tensor(rng.uniform(0.3, 1.0, size=2), device=device)
                    sec += tone[:, None] * gains
            if kind != 0:
                noise = torch.randn((m, 2), generator=gen, device=device, dtype=torch.float64)
                if rng.random() < 0.5:  # one-pole low-pass, applied in frequency
                    w = 2 * math.pi * torch.fft.rfftfreq(m, device=device, dtype=torch.float64)
                    h = (1 - a) / (1 - a * torch.exp(-1j * w))
                    noise = torch.fft.irfft(torch.fft.rfft(noise, dim=0) * h[:, None], n=m, dim=0)
                sec += noise * (0.5 if kind == 2 else 1.0)
            if rng.random() < 1.0 / 6.0:
                target = rng.uniform(-85.0, -78.0)
            else:
                step = rng.uniform(6.0, 20.0) * rng.choice([-1.0, 1.0])
                if not -40.0 <= level + step <= -8.0:
                    step = float(np.clip(level - step, -40.0, -8.0)) - level
                level = target = level + step
            rms = torch.sqrt(torch.mean(sec * sec)).clamp_min(1e-12)
            out[c, pos:pos + m] = (sec * (10.0 ** (target / 20.0) / rms)).to(torch.float32)
            pos += m
    return np.ascontiguousarray(out.cpu().numpy())


def stream_sources(seed: int, n_streams: int, clips: int, clip_frames: int) -> tuple[np.ndarray, np.ndarray]:
    """Each stream's clip and starting frame."""
    rng = _rng(seed, 2)
    return (rng.integers(0, clips, size=n_streams).astype(np.uint32),
            rng.integers(0, clip_frames, size=n_streams).astype(np.uint64))


def sample_streams(seed: int, n_streams: int, k: int) -> np.ndarray:
    """``k`` streams to check, one drawn from each of ``k`` equal runs of
    the batch (all streams where there are no more than ``k``)."""
    if n_streams <= k:
        return np.arange(n_streams)
    rng = _rng(seed, 3)
    edges = np.linspace(0, n_streams, k + 1).astype(np.int64)
    return np.array([rng.integers(lo, hi) for lo, hi in zip(edges[:-1], edges[1:])], np.int64)


def stream_samples(pool: np.ndarray, clip: int, offset: int, frames: int) -> np.ndarray:
    """``[frames, 2]`` float32: what the producer pushes to a stream of
    ``clip`` from ``offset``, the first ``frames`` of it."""
    n = pool.shape[1]
    idx = (int(offset) + np.arange(frames, dtype=np.int64)) % n
    return pool[int(clip)][idx]

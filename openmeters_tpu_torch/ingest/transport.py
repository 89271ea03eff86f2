"""ctypes binding for the native ingest transport (port of
``ingest/transport.py``; ``transport.cpp`` and ``feeder.cpp`` are the JAX
package's sources, copied unchanged).

The shared library builds with ``g++`` at first use into
``build/openmeters_tpu_torch/`` beside the package, named by a hash of the
sources and flags, so an unchanged tree builds once.  See
``transport.cpp`` for the semantics.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

_SRCS = [
    pathlib.Path(__file__).with_name("transport.cpp"),
    pathlib.Path(__file__).with_name("feeder.cpp"),
]
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "openmeters_tpu_torch"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_BUILD_LOCK = threading.Lock()


def library_path() -> pathlib.Path:
    h = hashlib.sha256()
    for src in _SRCS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"libopenmeters_transport-{h.hexdigest()[:16]}.so"


def _build() -> pathlib.Path:
    lib = library_path()
    with _BUILD_LOCK:
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = ["g++", *_FLAGS, "-o", str(tmp), *map(str, _SRCS)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, lib)
        return lib


def _load():
    lib = ctypes.CDLL(str(_build()))
    lib.om_transport_create.restype = ctypes.c_void_p
    lib.om_transport_create.argtypes = [
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
    ]
    lib.om_transport_destroy.argtypes = [ctypes.c_void_p]
    lib.om_push_pcm.restype = ctypes.c_int32
    lib.om_push_pcm.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_float), ctypes.c_uint32, ctypes.c_uint64,
    ]
    lib.om_push_silence.restype = ctypes.c_int32
    lib.om_push_silence.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64,
    ]
    lib.om_push_fault.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.om_set_generation.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64,
    ]
    lib.om_set_channels.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
    ]
    lib.om_stream_channels.restype = ctypes.c_uint32
    lib.om_stream_channels.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.om_fault_count.restype = ctypes.c_uint64
    lib.om_fault_count.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.om_assemble.restype = ctypes.c_int32
    lib.om_assemble.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.om_assemble_range.restype = ctypes.c_int32
    lib.om_assemble_range.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_uint32,
        ctypes.c_uint32,
    ]
    lib.om_assemble_buf.restype = ctypes.c_int32
    lib.om_assemble_buf.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_uint32,
        ctypes.c_uint32,
        ctypes.c_uint32,
    ]
    lib.om_set_active.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32]
    lib.om_is_active.restype = ctypes.c_uint32
    lib.om_is_active.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.om_buffered_frames.restype = ctypes.c_uint64
    lib.om_buffered_frames.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.om_backlog_blocks.restype = ctypes.c_uint32
    lib.om_backlog_blocks.argtypes = [ctypes.c_void_p]
    lib.om_feeder_start.restype = ctypes.c_void_p
    lib.om_feeder_start.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_double, ctypes.c_float, ctypes.c_uint32, ctypes.c_uint64,
        ctypes.c_uint32,
    ]
    lib.om_feeder_stop.argtypes = [ctypes.c_void_p]
    lib.om_feeder_ok.restype = ctypes.c_uint64
    lib.om_feeder_ok.argtypes = [ctypes.c_void_p]
    lib.om_feeder_failed.restype = ctypes.c_uint64
    lib.om_feeder_failed.argtypes = [ctypes.c_void_p]
    return lib


_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        _lib = _load()
    return _lib


class Transport:
    """Multi-stream host transport feeding fixed-shape engine batches.

    Producer threads call :meth:`push_pcm` / :meth:`push_silence` /
    :meth:`push_fault`; the engine loop calls :meth:`assemble` once per hop.
    """

    def __init__(
        self,
        n_streams: int,
        channels: int = 2,
        block_frames: int = 256,
        sample_rate: float = 48_000.0,
        ring_seconds: float = 4.0 / 3.0,  # transport.rs:15-18
        max_backlog_seconds: float = 1.0,  # transport.rs:17
        max_silence_seconds: float = 2.0,  # meter.rs:18
    ):
        self._lib = _get_lib()
        self.n_streams = n_streams
        self.channels = channels
        self.block_frames = block_frames
        self.sample_rate = sample_rate
        self._h = self._lib.om_transport_create(
            n_streams, channels, block_frames, sample_rate,
            ring_seconds, max_backlog_seconds, max_silence_seconds,
        )
        self._batch = np.zeros((n_streams, block_frames, channels), np.float32)
        self._reset = np.zeros((n_streams,), np.uint8)
        self._underrun = np.zeros((n_streams,), np.uint8)
        # host-side mirror of each stream's negotiated width so the hot
        # push path validates without an FFI round-trip per push; writes
        # happen on the stream's own producer thread (set_channels contract)
        self._stream_channels = np.full((n_streams,), channels, np.int32)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.om_transport_destroy(self._h)
            self._h = None

    def push_pcm(self, stream: int, samples: np.ndarray, timestamp_ns: int) -> int:
        """``samples``: [frames, channels] float32 interleaved.

        The channel count must match the stream's negotiated format
        (:meth:`set_channels`); the native side reads exactly
        ``frames * stream_channels`` floats, so a mismatched payload here
        would be an out-of-bounds read — rejected instead.
        """
        samples = np.ascontiguousarray(samples, np.float32)
        if samples.ndim != 2:
            raise ValueError(f"expected [frames, channels], got {samples.shape}")
        expect = int(self._stream_channels[stream])
        if samples.shape[1] != expect:
            raise ValueError(
                f"stream {stream} expects {expect} channels, got {samples.shape[1]}"
            )
        frames = samples.shape[0]
        return self._lib.om_push_pcm(
            self._h, stream,
            samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            frames, timestamp_ns,
        )

    def push_silence(self, stream: int, frames: int, timestamp_ns: int) -> int:
        return self._lib.om_push_silence(self._h, stream, frames, timestamp_ns)

    def push_fault(self, stream: int) -> None:
        self._lib.om_push_fault(self._h, stream)

    def set_active(self, stream: int, active: bool) -> None:
        """Pause/resume a stream (activity epochs, transport.rs:668-704).
        While paused the producer path drops input; resuming discards any
        stale backlog and emits one reset on the next assemble."""
        self._lib.om_set_active(self._h, stream, 1 if active else 0)

    def is_active(self, stream: int) -> bool:
        return bool(self._lib.om_is_active(self._h, stream))

    def set_generation(self, stream: int, generation: int) -> None:
        self._lib.om_set_generation(self._h, stream, generation)

    def set_channels(self, stream: int, channels: int) -> None:
        """Renegotiate a stream's channel layout (stream.rs:24-264).  Call
        from the stream's producer thread, paired with a generation bump."""
        self._lib.om_set_channels(self._h, stream, channels)
        # mirror the native clamp exactly (om_set_channels: [1, 64]) so the
        # push-path guard can never diverge from the width the ring uses
        self._stream_channels[stream] = min(max(int(channels), 1), 64)

    def stream_channels(self, stream: int) -> int:
        return self._lib.om_stream_channels(self._h, stream)

    def fault_count(self, stream: int) -> int:
        return self._lib.om_fault_count(self._h, stream)

    def buffered_frames(self, stream: int) -> int:
        return self._lib.om_buffered_frames(self._h, stream)

    def assemble(self, pool=None, shards: int = 1, out=None, buf_id=None):
        """Drain one hop: returns (batch [S,B,C] f32, reset [S] bool,
        underrun [S] bool, n_live).

        ``buf_id`` (0-3) identifies a stable caller buffer slot so idle
        stream rows that are already zero in that buffer skip re-zeroing.

        With ``pool`` (a ``concurrent.futures.ThreadPoolExecutor``) and
        ``shards > 1``, disjoint stream ranges are assembled concurrently —
        ctypes releases the GIL for the duration of each native call, so
        this scales the host assembler across cores for large stream counts.

        ``out=(batch, reset, underrun)`` assembles into caller-owned numpy
        buffers instead of the shared internal ones — the serving loop
        alternates two buffer sets so the asynchronous copy of hop N to the
        card can overlap assembly of hop N+1.
        """
        batch, reset, underrun = out if out is not None else (
            self._batch, self._reset, self._underrun
        )
        bid = 0xFF if buf_id is None else buf_id
        outp = batch.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        rst = reset.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        und = underrun.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        if pool is None or shards <= 1:
            n_live = self._lib.om_assemble_buf(
                self._h, outp, rst, und, 0, self.n_streams, bid
            )
        else:
            step = -(-self.n_streams // shards)
            futs = [
                pool.submit(
                    self._lib.om_assemble_buf, self._h, outp, rst, und,
                    lo, min(lo + step, self.n_streams), bid,
                )
                for lo in range(0, self.n_streams, step)
            ]
            n_live = sum(f.result() for f in futs)
        return batch, reset.astype(bool), underrun.astype(bool), n_live

    def make_buffers(self, pin_memory: bool = False):
        """One zeroed ``(batch, reset, underrun)`` buffer set for
        :meth:`assemble`.  With ``pin_memory`` the arrays are numpy views of
        page-locked ``torch`` tensors, so a card can copy from them
        asynchronously."""
        shapes = (
            ((self.n_streams, self.block_frames, self.channels), np.float32),
            ((self.n_streams,), np.uint8),
            ((self.n_streams,), np.uint8),
        )
        if not pin_memory:
            return tuple(np.zeros(shape, dtype) for shape, dtype in shapes)
        import torch

        dtypes = {np.float32: torch.float32, np.uint8: torch.uint8}
        return tuple(
            torch.zeros(shape, dtype=dtypes[dtype], pin_memory=True).numpy() for shape, dtype in shapes
        )

    def backlog_blocks(self) -> int:
        """Max whole blocks buffered over all streams — the serving loop
        runs this many extra catch-up hops (coalescing, meter.rs:15-80)."""
        return self._lib.om_backlog_blocks(self._h)


class Feeder:
    """Native synthetic producer threads (feeder.cpp): phase-continuous tone
    PCM pushed at real-time pace (or flat out with backpressure) — the
    hermetic stand-in for a live capture daemon in serve benchmarks."""

    def __init__(
        self,
        transport: Transport,
        begin: int = 0,
        end: int | None = None,
        frames_per_push: int | None = None,
        amplitude: float = 0.5,
        realtime: bool = True,
        max_buffered_frames: int = 0,
        n_threads: int = 4,
    ):
        self._lib = transport._lib
        self._transport = transport  # keep alive
        self._h = self._lib.om_feeder_start(
            transport._h,
            begin,
            transport.n_streams if end is None else end,
            frames_per_push or transport.block_frames,
            transport.sample_rate,
            amplitude,
            1 if realtime else 0,
            max_buffered_frames,
            n_threads,
        )

    def stop(self) -> tuple[int, int]:
        """Stop threads; returns (ok_pushes, failed_pushes)."""
        if self._h:
            ok = self._lib.om_feeder_ok(self._h)
            failed = self._lib.om_feeder_failed(self._h)
            self._lib.om_feeder_stop(self._h)
            self._h = None
            return int(ok), int(failed)
        return 0, 0

    def counts(self) -> tuple[int, int]:
        if not self._h:
            return 0, 0
        return (
            int(self._lib.om_feeder_ok(self._h)),
            int(self._lib.om_feeder_failed(self._h)),
        )

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.om_feeder_stop(self._h)
            self._h = None

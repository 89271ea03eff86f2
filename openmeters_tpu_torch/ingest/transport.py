"""ctypes binding for the native ingest transport (port of
``ingest/transport.py``; ``feeder.cpp`` is the JAX package's source, copied
unchanged).

``transport.cpp`` started as the JAX package's and keeps its semantics.  It
differs in where the samples live and when ring space is freed: every
stream's ring lies in one page-aligned arena, and its one assembler, the
descriptor pass (:meth:`Transport.assemble_desc`), leaves the samples
there, so that a card gathers them (``ops/ring_gather.py``; the gathered
rows are the JAX package's batch for the same pushes); their space goes
back to the producers at a later pass into the same buffer set.

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

from openmeters_tpu_torch.tracing import span

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
    lib.om_arena.restype = ctypes.c_void_p
    lib.om_arena.argtypes = [ctypes.c_void_p]
    lib.om_arena_bytes.restype = ctypes.c_uint64
    lib.om_arena_bytes.argtypes = [ctypes.c_void_p]
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
    lib.om_assemble_desc.restype = ctypes.c_int32
    lib.om_assemble_desc.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint32,
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


# the descriptor pass's row kinds, in the order om_assemble_desc counts them
ROW_KINDS = ("one_segment", "two_segments", "staged", "zero")


class Transport:
    """Multi-stream host transport feeding fixed-shape engine batches.

    Producer threads call :meth:`push_pcm` / :meth:`push_silence` /
    :meth:`push_fault`; the engine loop calls :meth:`assemble_desc` once
    per hop (:meth:`assemble`, the JAX package's call, runs it and gathers
    the rows on the host).  ``ingest_rows`` counts the descriptor pass's
    rows by kind (:data:`ROW_KINDS`) since the start.
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
        if not self._h:
            raise MemoryError(f"the ring arena of {n_streams} streams could not be mapped")
        self._pinned = None  # the devices the arena is registered for (pin_arena)
        self._arena = None
        self.ingest_rows = np.zeros((len(ROW_KINDS),), np.uint64)
        # host-side mirror of each stream's negotiated width so the hot
        # push path validates without an FFI round-trip per push; writes
        # happen on the stream's own producer thread (set_channels contract)
        self._stream_channels = np.full((n_streams,), channels, np.int32)

    def __del__(self):
        if getattr(self, "_h", None):
            self.unpin_arena()
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

    def assemble(self, pool=None, shards: int = 1):
        """Drain one hop as the JAX package's ``Transport.assemble`` does:
        returns (batch [S,B,C] f32, reset [S] bool, underrun [S] bool,
        n_live).  A descriptor pass into buffer set 0, releasing what the
        last one read, then its rows gathered on the host into a new batch;
        so a caller mixes this with :meth:`assemble_desc` only while no
        gather is pending.  ``pool`` and ``shards`` as for
        :meth:`assemble_desc`."""
        import torch

        from openmeters_tpu_torch.ops.ring_gather import ring_gather_reference

        bufs = self.make_desc_buffers()
        reset, underrun, n_live = self.assemble_desc(bufs, 0, pool=pool, shards=shards)
        staging, desc = torch.from_numpy(bufs[0]), torch.from_numpy(bufs[3])
        batch = torch.empty((self.n_streams, self.block_frames, self.channels))
        ring_gather_reference(self.arena_tensor(), staging, desc, batch)
        return batch.numpy(), reset, underrun, n_live

    def assemble_desc(self, out, slot: int, pool=None, shards: int = 1, release: bool = True):
        """Drain one hop into descriptors: returns (reset [S] bool,
        underrun [S] bool, n_live).

        ``out=(staging, reset, underrun, desc)`` (:meth:`make_desc_buffers`)
        receives a descriptor a row (``ops/ring_gather.py`` has the format
        and gathers them) and the rows the pass copies.  The ring space the
        descriptors name stays held for buffer set ``slot`` (0-3) until a
        later pass into the set with ``release``, which gives back what the
        passes into it since the last release read, each stream's before it
        reads the stream.  So a caller passes ``release`` on its first pass
        into a set once the gather out of the set is done, and not on
        further passes into it before that set's rows are gathered.

        With ``pool`` (a ``concurrent.futures.ThreadPoolExecutor``) and
        ``shards > 1``, disjoint stream ranges are assembled concurrently:
        ctypes releases the GIL for the duration of each native call.
        """
        with span("ingest.assemble"):
            staging, reset, underrun, desc = out
            f32, u8 = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)
            args = (
                self._h, staging.ctypes.data_as(f32), reset.ctypes.data_as(u8), underrun.ctypes.data_as(u8),
                desc.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
            step = self.n_streams if pool is None or shards <= 1 else -(-self.n_streams // shards)
            ranges = [(lo, min(lo + step, self.n_streams)) for lo in range(0, self.n_streams, step)]
            counts = np.zeros((len(ranges), len(ROW_KINDS)), np.uint64)

            def run(k):
                lo, hi = ranges[k]
                cnt = counts[k].ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
                return self._lib.om_assemble_desc(*args, cnt, lo, hi, slot, int(release))

            if len(ranges) == 1:
                lives = [run(0)]
            else:
                lives = [f.result() for f in [pool.submit(run, k) for k in range(len(ranges))]]
            if min(lives) < 0:
                raise ValueError(f"buffer set {slot} outside 0-3")
            self.ingest_rows += counts.sum(axis=0, dtype=np.uint64)
            return reset.astype(bool), underrun.astype(bool), sum(lives)

    def make_desc_buffers(self, pin_memory: bool = False):
        """One zeroed ``(staging, reset, underrun, desc)`` buffer set for
        :meth:`assemble_desc`.  With ``pin_memory`` the arrays are numpy
        views of page-locked ``torch`` tensors, so a card reads the staging
        rows and descriptors in place."""
        shapes = (
            ((self.n_streams, self.block_frames, self.channels), np.float32),
            ((self.n_streams,), np.uint8),
            ((self.n_streams,), np.uint8),
            ((self.n_streams, 4), np.int64),
        )
        if not pin_memory:
            return tuple(np.zeros(shape, dtype) for shape, dtype in shapes)
        import torch

        dtypes = {np.float32: torch.float32, np.uint8: torch.uint8, np.int64: torch.int64}
        return tuple(
            torch.zeros(shape, dtype=dtypes[dtype], pin_memory=True).numpy() for shape, dtype in shapes
        )

    def arena_tensor(self):
        """A float32 ``torch`` vector over the ring arena (no copy), the
        source the descriptors index; valid while the transport lives."""
        if self._arena is None:
            import torch

            n = self._lib.om_arena_bytes(self._h) // 4
            buf = (ctypes.c_float * n).from_address(self._lib.om_arena(self._h))
            self._arena = torch.from_numpy(np.ctypeslib.as_array(buf))
        return self._arena

    def pin_arena(self, devices) -> None:
        """Register the ring arena as mapped, portable pinned memory, so
        the cards of ``devices`` read the rings in place; undone by
        :meth:`unpin_arena`, or before the transport frees the arena."""
        if self._pinned is not None:
            return
        from openmeters_tpu_torch.ops.ring_gather import host_register

        host_register(self._lib.om_arena(self._h), self._lib.om_arena_bytes(self._h))
        self._pinned = tuple(devices)

    def unpin_arena(self) -> None:
        """Wait for the cards of :meth:`pin_arena`, then unregister the
        arena."""
        if self._pinned is None:
            return
        import torch

        from openmeters_tpu_torch.ops.ring_gather import host_unregister

        for dev in set(self._pinned):
            torch.cuda.synchronize(dev)
        host_unregister(self._lib.om_arena(self._h))
        self._pinned = None

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

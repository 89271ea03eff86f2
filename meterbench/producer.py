"""ctypes binding of ``producer.cpp``: native threads that push the pool's
clips into a transport flat out under backpressure.

The library builds with ``g++`` at first use into ``build/meterbench/`` of
the checkout, named by a hash of the source and flags, so a checkout
builds it once."""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess

import numpy as np

SRC = pathlib.Path(__file__).with_name("producer.cpp")
ROOT = pathlib.Path(__file__).resolve().parents[1]
BUILD_DIR = ROOT / "build" / "meterbench"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def library_path() -> pathlib.Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libmeterbench_producer-{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, "-o", str(tmp), str(SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _load():
    lib = ctypes.CDLL(str(build()))
    lib.mb_producer_start.restype = ctypes.c_void_p
    lib.mb_producer_start.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float), ctypes.c_uint32, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64, ctypes.c_double, ctypes.c_uint32,
    ]
    for name in ("mb_producer_stop", "mb_producer_free"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
        getattr(lib, name).restype = None
    for name in ("mb_producer_ok", "mb_producer_failed", "mb_producer_min_buffered"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_uint64
    return lib


class Producer:
    """Push ``pool [clips, clip_frames, 2]`` float32 into ``transport``:
    stream ``s`` reads clip ``clip_of[s]`` cyclically from frame
    ``offset_of[s]``.  ``transport`` is the port's ``Transport``; only its
    handle and the addresses of its C entries ``om_push_pcm`` and
    ``om_buffered_frames`` are used."""

    def __init__(self, transport, pool: np.ndarray, clip_of: np.ndarray, offset_of: np.ndarray,
                 frames_per_push: int, max_buffered_frames: int, threads: int, sample_rate: float):
        if pool.dtype != np.float32 or pool.ndim != 3 or pool.shape[2] != 2 or not pool.flags.c_contiguous:
            raise ValueError(f"pool must be a C-contiguous [clips, frames, 2] float32 array, got {pool.shape}")
        n = transport.n_streams
        if clip_of.shape != (n,) or offset_of.shape != (n,):
            raise ValueError(f"clip_of and offset_of must hold {n} streams")
        if int(clip_of.max()) >= pool.shape[0]:
            raise ValueError("clip_of names a clip past the pool")
        self._lib = _load()
        # kept alive while the threads read them
        self._pool = pool
        self._clip_of = np.ascontiguousarray(clip_of, np.uint32)
        self._offset_of = np.ascontiguousarray(offset_of % pool.shape[1], np.uint64)
        self._transport = transport
        tlib = transport._lib  # noqa: SLF001
        push = ctypes.cast(tlib.om_push_pcm, ctypes.c_void_p).value
        buffered = ctypes.cast(tlib.om_buffered_frames, ctypes.c_void_p).value
        self._h = self._lib.mb_producer_start(
            transport._h, push, buffered,  # noqa: SLF001
            pool.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), pool.shape[0], pool.shape[1],
            self._clip_of.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            self._offset_of.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            n, frames_per_push, max_buffered_frames, float(sample_rate), threads,
        )
        if not self._h:
            raise RuntimeError("mb_producer_start refused its arguments")
        self._stopped = False

    def min_buffered(self) -> int:
        return int(self._lib.mb_producer_min_buffered(self._h))

    def counts(self) -> tuple[int, int]:
        """(pushes accepted, pushes refused)."""
        return int(self._lib.mb_producer_ok(self._h)), int(self._lib.mb_producer_failed(self._h))

    def stop(self) -> tuple[int, int]:
        """Stop and join the threads; returns :meth:`counts`."""
        if not self._stopped:
            self._lib.mb_producer_stop(self._h)
            self._stopped = True
        return self.counts()

    def close(self) -> None:
        if self._h:
            self.stop()
            self._lib.mb_producer_free(self._h)
            self._h = None

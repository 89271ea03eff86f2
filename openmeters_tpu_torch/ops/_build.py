"""Build the package's CUDA sources with ``nvcc`` at first use.

Every ``csrc/*.cu`` compiles into one shared library with a plain C
interface, loaded with :mod:`ctypes`.  The library lands in
``build/openmeters_tpu_torch/`` beside the package, named by a hash of the
sources and flags, so an unchanged tree builds once and a changed one
rebuilds.  The compiler's report (``-Xptxas -v``: registers, shared
memory, spills) is kept next to the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "openmeters_tpu_torch"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libopenmeters_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for their hash exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
    cmd = [
        find_nvcc(),
        *NVCC_FLAGS,
        "-o",
        str(tmp),
        *[str(p) for p in sorted(CSRC.glob("*.cu"))],
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first call and declared for ctypes."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.sliding_hop_launch.argtypes = [
                p, p, p, p, p, p, p, p, p,  # fr fi deltas upd_r upd_i rot_r rot_i dc norm
                p, p, p,  # fr_out fi_out codes
                i, i, i, i, i,  # S cols hop bins ready
                f, f, f, f, f, i, i,  # inv_n a0 h1 h2 h3 reach dc_bins
                f, f,  # floor_db store_scale
                p,  # stream
            ]
            lib.sliding_hop_launch.restype = ctypes.c_int
            _lib = lib
        return _lib


def build_log() -> str:
    """The compiler's report for the current sources, once built."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""

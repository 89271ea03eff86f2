"""Build the package's CUDA sources with ``nvcc`` at first use.

Every ``csrc/*.cu`` compiles to an object, one ``nvcc`` per source, all
started together; the objects link into one shared library with a plain C
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
import re
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
    nvcc = find_nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )))
    log, failed = [], []
    for cmd, _, proc in jobs:
        stdout, stderr = proc.communicate()
        log.append(f"$ {' '.join(cmd)}\n{stdout}{stderr}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{stderr}")
    tmp = out.parent / f"{tag}.tmp"
    if not failed:
        cmd = [nvcc, NVCC_FLAGS[0], "-shared", "-o", str(tmp), *[str(o) for _, o, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            failed.append(f"link failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("\n".join(failed))
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
                p, p, p, p, p, p, p, p,  # fr fi deltas tiles rot_r rot_i dc norm
                p, p, p,  # fr_out fi_out out
                i, i, i, i, i,  # S cols hop bins ready
                f, f, f, f, f, i, i,  # inv_n a0 h1 h2 h3 reach dc_bins
                f, f, i,  # floor_db store_scale emit_codes
                p,  # stream
            ]
            lib.sliding_hop_launch.restype = ctypes.c_int
            lib.sliding_hop_spectra_launch.argtypes = [
                p, p, p, p, p, p, p,  # fr fi dspec rot_r rot_i dc norm
                p, p, p,  # fr_out fi_out out
                i, i, i, i,  # S cols bins ready
                f, f, f, f, f, i, i,  # inv_n a0 h1 h2 h3 reach dc_bins
                f, f, i,  # floor_db store_scale emit_codes
                p,  # stream
            ]
            lib.sliding_hop_spectra_launch.restype = ctypes.c_int
            lib.sliding_hop_block_launch.argtypes = [
                p, p, p, p, p, p, p, p, p,  # fr fi deltas build_tw fft_tw rot_r rot_i dc norm
                p, p, p,  # fr_out fi_out out
                i, i, i, i, i,  # S cols hop n ready
                f, f, f, f, f, i, i,  # inv_n a0 h1 h2 h3 reach dc_bins
                f, f, i,  # floor_db store_scale emit_codes
                p,  # stream
            ]
            lib.sliding_hop_block_launch.restype = ctypes.c_int
            lib.reassigned_hop_launch.argtypes = [
                *[p] * 16,  # eight states in, eight out
                p, p, p,  # dx dh tiles
                p, p, p, p,  # rot_r rot_i normq freqb
                p, p, p,  # freq time power
                i, i, i, i, i, i, i,  # S cols hop bins ready zpf nterms
                f, f, f, f, f, f, f,  # a0 halves[3] gs[3]
                f, f, f,  # inv_2pi inv_hop latency_hops
                p,  # stream
            ]
            lib.reassigned_hop_launch.restype = ctypes.c_int
            lib.reassigned_columns_launch.argtypes = [
                p, p, p, p, p,  # frames twiddles dif_twiddles dit_twiddles norm
                p, p, p,  # freq time power
                i, i, i,  # rows n nterms
                f, f, f, f, f, f, f,  # a0 halves[3] gs[3]
                f, f, f, f,  # bin_hz inv_2pi inv_hop latency_hops
                p,  # stream
            ]
            lib.reassigned_columns_launch.restype = ctypes.c_int
            lib.classic_columns_launch.argtypes = [
                p, p, p, p, p, p,  # ring window twiddles dif_twiddles norm out
                i, i, i, i, i, i, i,  # S ring_len base hop ready cols n
                f, f,  # floor_db store_scale
                p,  # stream
            ]
            lib.classic_columns_launch.restype = ctypes.c_int
            lib.corr_search_launch.argtypes = [
                p, p, p,  # src starts tmpl
                p, p, p, p, p,  # klen wlen shift dif_twiddles dit_twiddles
                p, p, p, p,  # dots sx sxx wmean
                p, i,  # scratch grid
                i, i, i, i, i, i, i,  # rows src_len wcap tmpl_len n out_len sums
                p,  # stream
            ]
            lib.corr_search_launch.restype = ctypes.c_int
            lib.window_rows_launch.argtypes = [p, p, p, i, i, i, i, p]  # x starts out rows n windows length stream
            lib.window_rows_launch.restype = ctypes.c_int
            lib.three_band_launch.argtypes = [p, p, p, p, p, i, i, i, i, p]  # x state coeffs bands state_out T L cascade_n high_from_al stream
            lib.three_band_launch.restype = ctypes.c_int
            lib.ring_gather_launch.argtypes = [p, p, p, p, ctypes.c_longlong, i, i, p]  # arena staging desc out row0 rows row_len stream
            lib.ring_gather_launch.restype = ctypes.c_int
            lib.ring_host_register.argtypes = [p, ctypes.c_ulonglong]
            lib.ring_host_register.restype = ctypes.c_int
            lib.ring_host_unregister.argtypes = [p]
            lib.ring_host_unregister.restype = ctypes.c_int
            lib.ring_host_device_pointer.argtypes = [p, ctypes.POINTER(ctypes.c_void_p)]
            lib.ring_host_device_pointer.restype = ctypes.c_int
            _lib = lib
        return _lib


def build_log() -> str:
    """The compiler's report for the current sources, once built."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"\bBRA(?:\.\S+)?\s+(?:\S+,\s*)?(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")


def kernel_sass(name: str, lib_path=None) -> dict[str, list[tuple[int, str]]]:
    """``{symbol: [(address, instruction), ...]}`` for each function of the
    built library (or of ``lib_path``) whose symbol holds ``name``: its SASS
    from ``cuobjdump -sass``, a branch's target given as an address
    (``"@!P0 BRA 0xce0"``) whichever way the tool printed it."""
    tool = Path(find_nvcc()).parent / "cuobjdump"
    lib = lib_path or library_path()
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    found = {}
    for part in sass.split("Function : ")[1:]:
        symbol, _, body = part.partition("\n")
        if name not in symbol:
            continue
        instrs, labels, pending = [], {}, []
        for line in body.splitlines():
            label, instr = _LABEL.match(line), _INSTR.search(line)
            if label:
                pending.append(label.group(1))
            elif instr:
                addr = int(instr.group(1), 16)
                labels.update((p, addr) for p in pending)
                pending = []
                instrs.append((addr, instr.group(2)))
        for i, (addr, text) in enumerate(instrs):
            target = _TARGET.search(text)
            if target and target.group(1):
                instrs[i] = (addr, text.replace(f"`({target.group(1)})", hex(labels[target.group(1)])))
        found[symbol.strip()] = instrs
    return found


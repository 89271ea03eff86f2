"""The sliding-DFT hop: CUDA kernel wrappers and plain versions.

Replaces ``openmeters_tpu/ops/pallas_sliding.py::sliding_hop``, both its
variants.  For each of ``cols`` columns in order: slide and rotate the
``[S, bins]`` spectrum state by that column's delta spectrum (held when
``k >= ready``), apply the cosine-sum window as a frequency-domain stencil
with hermitian edge reflection, remove the DC mean, take power, and emit it
as float32 or packed as dB to uint16 codes over [-144, +12] dB.

- :func:`sliding_hop` (the whole-row variant, "B1a") computes the delta
  spectra itself from the ``[S, cols, hop]`` sample deltas and the
  ``[hop, bins]`` DFT update matrices.
- :func:`sliding_hop_spectra` ("B1b", the JAX package's bin-tiled variant)
  takes the same sample deltas, for configs whose update matrices are too
  large to stream, and computes each column's delta spectrum
  ``rfft(delta, n)`` as a pruned transform of its ``hop`` samples.

They launch ``csrc/sliding_hop_deltas.cu`` (B1a: the delta products on the
tensor cores in 3xTF32, then the slide) and ``csrc/sliding_hop.cu`` (B1b:
one block a stream's row for ``n <= BLOCK_MAX_N``, by :func:`block_fits`;
past it the delta spectra from ``torch.fft.rfft`` and the bin-tiled kernel)
for CUDA tensors and run their plain versions for CPU tensors; on any
other device they raise.  ``.launches`` on each counts its kernel's
launches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from openmeters_tpu_torch.ops.block_fft import plan_table
from openmeters_tpu_torch.ops.update_tiles import KC, update_tiles
from openmeters_tpu_torch.utils.level import power_to_db

# fixed u16 dB storage domain of the classic spectrogram
CLASSIC_DB_STORE_LO = -144.0
CLASSIC_DB_STORE_HI = 12.0
CLASSIC_DB_STORE_RANGE = CLASSIC_DB_STORE_HI - CLASSIC_DB_STORE_LO
STORE_SCALE = 65535.0 / CLASSIC_DB_STORE_RANGE
MAX_REACH = 3  # the kernel's halo: len(coeffs) - 1
TILE_EXT = 128  # bins B1a slides per block, halo included
BLOCK_MAX_N = 16384  # the largest FFT whose row and delta transforms fit one B1b block's shared memory
BLOCK_FFT_STAGES = 3  # radix-2 stages a pass of B1b's P-point transforms


def block_fits(n: int) -> bool:
    """Whether B1b's whole-row kernel takes ``n``-point configs: one block
    holds a stream's row and its delta transforms in shared memory up to
    ``BLOCK_MAX_N`` (197 KB at 16384 points, hop 8192).  Larger configs take
    the delta spectra from ``torch.fft.rfft`` and the bin-tiled kernel."""
    return n <= BLOCK_MAX_N


def pack_classic_db(db: torch.Tensor) -> torch.Tensor:
    """dB -> u16 code over the fixed store domain (round half to even)."""
    code = torch.round((db - CLASSIC_DB_STORE_LO) * STORE_SCALE)
    return torch.clamp(code, 0.0, 65535.0).to(torch.uint16)


def window_stencil(fr, fi, coeffs):
    """Cosine-sum window as a frequency stencil over ``[..., bins]`` with
    hermitian reflection at bin 0 and at Nyquist (real input)."""
    bins = fr.shape[-1]
    wr = float(coeffs[0]) * fr
    wi = float(coeffs[0]) * fi
    for j, a in enumerate(coeffs[1:], start=1):
        half = 0.5 * float(a)
        lo_r = torch.cat([fr[..., 1 : j + 1].flip(-1), fr[..., : bins - j]], dim=-1)
        lo_i = torch.cat([-fi[..., 1 : j + 1].flip(-1), fi[..., : bins - j]], dim=-1)
        hi_r = torch.cat([fr[..., j:], fr[..., bins - j - 1 : bins - 1].flip(-1)], dim=-1)
        hi_i = torch.cat([fi[..., j:], -fi[..., bins - j - 1 : bins - 1].flip(-1)], dim=-1)
        wr = wr + half * (lo_r + hi_r)
        wi = wi + half * (lo_i + hi_i)
    return wr, wi


def _slide_columns(ready, fr, fi, dr, di, rot_r, rot_i, dc_corr, norm, n, coeffs,
                   floor_db, emit_codes):
    """The column loop shared by both plain versions, from the delta
    spectra ``dr, di [S, cols, bins]``."""
    out = []
    for k in range(dr.shape[1]):
        if k < ready:
            tr = fr + dr[:, k]
            ti = fi + di[:, k]
            fr, fi = tr * rot_r - ti * rot_i, tr * rot_i + ti * rot_r
        wr, wi = window_stencil(fr, fi, coeffs)
        wr = wr - fr[:, 0:1] * (1.0 / n) * dc_corr
        p = (wr * wr + wi * wi) * norm
        out.append(pack_classic_db(power_to_db(p, floor_db)) if emit_codes else p)
    return fr, fi, torch.stack(out, dim=1)


def sliding_hop_reference(
    ready, fr, fi, deltas, upd_r, upd_i, rot_r, rot_i, dc_corr, norm,
    *, n: int, coeffs: tuple, floor_db: float, emit_codes: bool = True,
):
    """Plain PyTorch version of :func:`sliding_hop`, same arguments and
    results."""
    dr = torch.matmul(deltas, upd_r)  # [S, cols, bins]
    di = torch.matmul(deltas, upd_i)
    return _slide_columns(ready, fr, fi, dr, di, rot_r, rot_i, dc_corr, norm, n, coeffs,
                          floor_db, emit_codes)


def sliding_hop_spectra_reference(
    ready, fr, fi, deltas, rot_r, rot_i, dc_corr, norm,
    *, n: int, coeffs: tuple, floor_db: float, emit_codes: bool,
):
    """Plain PyTorch version of :func:`sliding_hop_spectra`, same
    arguments and results: the deltas' rFFT, then the column loop."""
    dspec = torch.fft.rfft(deltas, n=n)  # [S, cols, bins] complex64
    return _slide_columns(ready, fr, fi, dspec.real, dspec.imag, rot_r, rot_i, dc_corr, norm,
                          n, coeffs, floor_db, emit_codes)


@functools.lru_cache(maxsize=None)
def _block_tables(n: int, hop: int, device: torch.device):
    """B1b's twiddles on ``device``: ``exp(-2 pi i m r / n)`` at ``r P + m``
    for ``r <= R/2`` and ``m < P`` (``P`` = ``hop`` rounded up to a power
    of two, ``R = n / P``), and the ``P``-point plan's table; computed in
    float64, stored as interleaved float32."""
    lp = (hop - 1).bit_length()
    r, m = np.divmod(np.arange(((n >> lp) // 2 + 1) << lp), 1 << lp)
    ang = -2.0 * np.pi * (m * r).astype(np.float64) / n
    build = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    return torch.from_numpy(build).to(device), plan_table(lp, BLOCK_FFT_STAGES, False, device)


def _check(tensors: dict, device, what: str) -> None:
    for name, (x, shape, dtype) in tensors.items():
        if x.device != device or x.dtype != dtype:
            raise ValueError(f"{what} {name}: want {dtype} on {device}, got {x.dtype} on {x.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{what} {name}: want contiguous {shape}, got {tuple(x.shape)}")


def _window_args(coeffs: tuple) -> tuple:
    """``(a0, h1, h2, h3, reach)`` for the kernel's stencil."""
    reach = len(coeffs) - 1
    halves = [0.5 * float(a) for a in coeffs[1:]] + [0.0] * (MAX_REACH - reach)
    return (float(coeffs[0]), *halves, reach)


def hop_tiles(upd_r: torch.Tensor, upd_i: torch.Tensor) -> torch.Tensor:
    """The ``[hop, bins]`` update matrices as the B1a kernel stages them
    (``ops/update_tiles.py``: parts re | im, bin tiles of 128 with a halo
    of 3)."""
    return update_tiles(torch.cat([upd_r, upd_i], dim=1), upd_r.shape[1], 2, TILE_EXT, MAX_REACH)


def sliding_hop(
    ready, fr, fi, deltas, upd_r, upd_i, rot_r, rot_i, dc_corr, norm,
    *, n: int, coeffs: tuple, floor_db: float, emit_codes: bool = True, tiles=None,
):
    """One hop of the sliding DFT from sample deltas (B1a).

    Args:
      ready: host int, columns whose slide applies this hop.
      fr, fi: ``[S, bins]`` float32 sliding spectrum state.
      deltas: ``[S, cols, hop]`` float32 per-column sample deltas.
      upd_r, upd_i: ``[hop, bins]`` DFT update matrices.
      rot_r, rot_i, dc_corr, norm: ``[bins]`` rows; ``dc_corr`` is zero
        past bin ``len(coeffs) - 1``.
      n: FFT size; coeffs: cosine-sum window coefficients (at most 4).
      emit_codes: uint16 dB codes if true, else float32 power.
      tiles: ``hop_tiles(upd_r, upd_i)``, which the kernel reads in place
        of ``upd_r, upd_i``; made here when not given (callers that hop
        many times keep it, as ``SlidingSTFT`` does).  The plain version
        ignores it.

    Returns ``(fr2, fi2, out)``, ``out`` ``[S, cols, bins]``.
    """
    kw = dict(n=n, coeffs=coeffs, floor_db=floor_db, emit_codes=emit_codes)
    if fr.device.type == "cpu":
        return sliding_hop_reference(
            ready, fr, fi, deltas, upd_r, upd_i, rot_r, rot_i, dc_corr, norm, **kw
        )
    if fr.device.type != "cuda":
        raise ValueError(f"sliding_hop runs on cpu or cuda tensors, not {fr.device}")
    s, bins = fr.shape
    _, cols, hop = deltas.shape
    f32 = torch.float32
    _check({
        "fr": (fr, (s, bins), f32), "fi": (fi, (s, bins), f32),
        "deltas": (deltas, (s, cols, hop), f32),
        "upd_r": (upd_r, (hop, bins), f32), "upd_i": (upd_i, (hop, bins), f32),
        "rot_r": (rot_r, (bins,), f32), "rot_i": (rot_i, (bins,), f32),
        "dc_corr": (dc_corr, (bins,), f32), "norm": (norm, (bins,), f32),
    }, fr.device, "sliding_hop")
    reach = len(coeffs) - 1
    if reach > MAX_REACH or hop % 4 or hop == 0 or s > 8 * 65535:
        raise ValueError(f"unsupported: reach {reach}, hop {hop}, streams {s}")
    if tiles is None:
        tiles = hop_tiles(upd_r, upd_i)
    tile_shape = (-(-bins // (TILE_EXT - 2 * MAX_REACH)), 2, -(-hop // KC), TILE_EXT * KC)
    _check({"tiles": (tiles, tile_shape, f32)}, fr.device, "sliding_hop")

    from openmeters_tpu_torch.ops._build import load_library

    lib = load_library()
    fr2 = torch.empty_like(fr)
    fi2 = torch.empty_like(fi)
    out = torch.empty((s, cols, bins), dtype=torch.uint16 if emit_codes else f32, device=fr.device)
    with torch.cuda.device(fr.device):
        stream = torch.cuda.current_stream(fr.device).cuda_stream
        rc = lib.sliding_hop_launch(
            fr.data_ptr(), fi.data_ptr(), deltas.data_ptr(), tiles.data_ptr(),
            rot_r.data_ptr(), rot_i.data_ptr(), dc_corr.data_ptr(), norm.data_ptr(),
            fr2.data_ptr(), fi2.data_ptr(), out.data_ptr(),
            s, cols, hop, bins, int(ready),
            1.0 / n, *_window_args(coeffs), len(coeffs),
            float(floor_db), STORE_SCALE, int(emit_codes), stream,
        )
    if rc != 0:
        raise RuntimeError(f"sliding_hop kernel launch failed: cudaError {rc}")
    sliding_hop.launches += 1
    return fr2, fi2, out


sliding_hop.launches = 0


def sliding_hop_spectra(
    ready, fr, fi, deltas, rot_r, rot_i, dc_corr, norm,
    *, n: int, coeffs: tuple, floor_db: float, emit_codes: bool,
):
    """One hop of the sliding DFT for large FFTs (B1b).

    Args:
      ready, fr, fi, deltas, rot_r, rot_i, dc_corr, norm, n, coeffs,
        floor_db, emit_codes: as for :func:`sliding_hop`; ``deltas`` is
        ``[S, cols, hop]`` float32 with ``hop <= n / 2``.

    Returns ``(fr2, fi2, out)``, ``out`` ``[S, cols, bins]`` uint16 codes or
    float32 power.  For ``n <= BLOCK_MAX_N`` one kernel launch computes the
    delta spectra too; past it the deltas' ``torch.fft.rfft`` goes to the
    bin-tiled kernel.
    """
    kw = dict(n=n, coeffs=coeffs, floor_db=floor_db, emit_codes=emit_codes)
    if fr.device.type == "cpu":
        return sliding_hop_spectra_reference(ready, fr, fi, deltas, rot_r, rot_i, dc_corr, norm, **kw)
    if fr.device.type != "cuda":
        raise ValueError(f"sliding_hop_spectra runs on cpu or cuda tensors, not {fr.device}")
    s, bins = fr.shape
    _, cols, hop = deltas.shape
    f32 = torch.float32
    _check({
        "fr": (fr, (s, bins), f32), "fi": (fi, (s, bins), f32),
        "deltas": (deltas, (s, cols, hop), f32),
        "rot_r": (rot_r, (bins,), f32), "rot_i": (rot_i, (bins,), f32),
        "dc_corr": (dc_corr, (bins,), f32), "norm": (norm, (bins,), f32),
    }, fr.device, "sliding_hop_spectra")
    reach = len(coeffs) - 1
    if reach > MAX_REACH or s > 8 * 65535 or n & (n - 1) or bins != n // 2 + 1 or not 0 < 2 * hop <= n:
        raise ValueError(f"unsupported: reach {reach}, streams {s}, n {n}, bins {bins}, hop {hop}")

    from openmeters_tpu_torch.ops._build import load_library

    lib = load_library()
    fr2 = torch.empty_like(fr)
    fi2 = torch.empty_like(fi)
    out = torch.empty((s, cols, bins), dtype=torch.uint16 if emit_codes else f32, device=fr.device)
    window = (1.0 / n, *_window_args(coeffs), len(coeffs), float(floor_db), STORE_SCALE, int(emit_codes))
    with torch.cuda.device(fr.device):
        stream = torch.cuda.current_stream(fr.device).cuda_stream
        if block_fits(n):
            build_tw, fft_tw = _block_tables(n, hop, fr.device)
            rc = lib.sliding_hop_block_launch(
                fr.data_ptr(), fi.data_ptr(), deltas.data_ptr(), build_tw.data_ptr(), fft_tw.data_ptr(),
                rot_r.data_ptr(), rot_i.data_ptr(), dc_corr.data_ptr(), norm.data_ptr(),
                fr2.data_ptr(), fi2.data_ptr(), out.data_ptr(),
                s, cols, hop, n, int(ready), *window, stream,
            )
        else:
            dspec = torch.fft.rfft(deltas, n=n)  # [S, cols, bins] complex64
            rc = lib.sliding_hop_spectra_launch(
                fr.data_ptr(), fi.data_ptr(), dspec.data_ptr(),
                rot_r.data_ptr(), rot_i.data_ptr(), dc_corr.data_ptr(), norm.data_ptr(),
                fr2.data_ptr(), fi2.data_ptr(), out.data_ptr(),
                s, cols, bins, int(ready), *window, stream,
            )
    if rc != 0:
        raise RuntimeError(f"sliding_hop_spectra kernel launch failed: cudaError {rc}")
    sliding_hop_spectra.launches += 1
    return fr2, fi2, out


sliding_hop_spectra.launches = 0

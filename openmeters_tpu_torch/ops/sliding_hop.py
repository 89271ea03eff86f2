"""The sliding-DFT spectrogram hop: CUDA kernel wrapper and plain version.

Replaces ``openmeters_tpu/ops/pallas_sliding.py::sliding_hop`` (whole-row
variant).  For each of ``cols`` columns in order: slide and rotate the
``[S, bins]`` spectrum state by that column's sample deltas (held when
``k >= ready``), apply the cosine-sum window as a frequency-domain stencil
with hermitian edge reflection, remove the DC mean, take power, and pack
dB to uint16 codes over [-144, +12] dB.

:func:`sliding_hop` launches ``csrc/sliding_hop.cu`` for CUDA tensors and
runs :func:`sliding_hop_reference` for CPU tensors; on any other device it
raises.  ``sliding_hop.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from openmeters_tpu_torch.utils.level import power_to_db

# fixed u16 dB storage domain of the classic spectrogram
CLASSIC_DB_STORE_LO = -144.0
CLASSIC_DB_STORE_HI = 12.0
CLASSIC_DB_STORE_RANGE = CLASSIC_DB_STORE_HI - CLASSIC_DB_STORE_LO
STORE_SCALE = 65535.0 / CLASSIC_DB_STORE_RANGE
MAX_REACH = 3  # the kernel's halo: len(coeffs) - 1


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


def sliding_hop_reference(
    ready, fr, fi, deltas, upd_r, upd_i, rot_r, rot_i, dc_corr, norm,
    *, n: int, coeffs: tuple, floor_db: float,
):
    """Plain PyTorch version of the hop.  Same arguments as
    :func:`sliding_hop`; returns ``(fr2, fi2, codes [S, cols, bins] uint16)``."""
    cols = deltas.shape[1]
    dr = torch.matmul(deltas, upd_r)  # [S, cols, bins]
    di = torch.matmul(deltas, upd_i)
    out = []
    for k in range(cols):
        if k < ready:
            tr = fr + dr[:, k]
            ti = fi + di[:, k]
            fr, fi = tr * rot_r - ti * rot_i, tr * rot_i + ti * rot_r
        wr, wi = window_stencil(fr, fi, coeffs)
        wr = wr - fr[:, 0:1] * (1.0 / n) * dc_corr
        out.append(pack_classic_db(power_to_db((wr * wr + wi * wi) * norm, floor_db)))
    return fr, fi, torch.stack(out, dim=1)


def sliding_hop(
    ready, fr, fi, deltas, upd_r, upd_i, rot_r, rot_i, dc_corr, norm,
    *, n: int, coeffs: tuple, floor_db: float,
):
    """One hop of the sliding-DFT spectrogram.

    Args:
      ready: host int, columns whose slide applies this hop.
      fr, fi: ``[S, bins]`` float32 sliding spectrum state.
      deltas: ``[S, cols, hop]`` float32 per-column sample deltas.
      upd_r, upd_i: ``[hop, bins]`` DFT update matrices.
      rot_r, rot_i, dc_corr, norm: ``[bins]`` rows; ``dc_corr`` is zero
        past bin ``len(coeffs) - 1``.
      n: FFT size; coeffs: cosine-sum window coefficients (at most 4).

    Returns ``(fr2, fi2, codes)``, codes ``[S, cols, bins]`` uint16.
    """
    if fr.device.type == "cpu":
        return sliding_hop_reference(
            ready, fr, fi, deltas, upd_r, upd_i, rot_r, rot_i, dc_corr, norm,
            n=n, coeffs=coeffs, floor_db=floor_db,
        )
    if fr.device.type != "cuda":
        raise ValueError(f"sliding_hop runs on cpu or cuda tensors, not {fr.device}")
    s, bins = fr.shape
    _, cols, hop = deltas.shape
    tensors = {
        "fr": (fr, (s, bins)), "fi": (fi, (s, bins)),
        "deltas": (deltas, (s, cols, hop)),
        "upd_r": (upd_r, (hop, bins)), "upd_i": (upd_i, (hop, bins)),
        "rot_r": (rot_r, (bins,)), "rot_i": (rot_i, (bins,)),
        "dc_corr": (dc_corr, (bins,)), "norm": (norm, (bins,)),
    }
    for name, (x, shape) in tensors.items():
        if x.device != fr.device or x.dtype != torch.float32:
            raise ValueError(f"{name}: want float32 on {fr.device}, got {x.dtype} on {x.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name}: want contiguous {shape}, got {tuple(x.shape)}")
    reach = len(coeffs) - 1
    if reach > MAX_REACH or hop % 4 or s > 8 * 65535:
        raise ValueError(f"unsupported: reach {reach}, hop {hop}, streams {s}")

    from openmeters_tpu_torch.ops._build import load_library

    lib = load_library()
    fr2 = torch.empty_like(fr)
    fi2 = torch.empty_like(fi)
    codes = torch.empty((s, cols, bins), dtype=torch.uint16, device=fr.device)
    halves = [0.5 * float(a) for a in coeffs[1:]] + [0.0] * (MAX_REACH - reach)
    with torch.cuda.device(fr.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sliding_hop_launch(
            fr.data_ptr(), fi.data_ptr(), deltas.data_ptr(),
            upd_r.data_ptr(), upd_i.data_ptr(), rot_r.data_ptr(),
            rot_i.data_ptr(), dc_corr.data_ptr(), norm.data_ptr(),
            fr2.data_ptr(), fi2.data_ptr(), codes.data_ptr(),
            s, cols, hop, bins, int(ready),
            1.0 / n, float(coeffs[0]), *halves, reach, len(coeffs),
            float(floor_db), STORE_SCALE, stream,
        )
    if rc != 0:
        raise RuntimeError(f"sliding_hop kernel launch failed: cudaError {rc}")
    sliding_hop.launches += 1
    return fr2, fi2, codes


sliding_hop.launches = 0

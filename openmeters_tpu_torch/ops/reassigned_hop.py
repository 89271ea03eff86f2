"""The sliding-analytic reassigned hop: CUDA kernel wrapper and plain version.

Replaces ``openmeters_tpu/ops/pallas_sliding_reassigned.py::
reassigned_sliding_hop``.  For each of ``cols`` columns in order: slide the
eight one-sided ``[S, bins]`` states (U and V of the raw signal x and of its
Hilbert transform hx, real and imaginary parts) by that column's delta
products against the fused ``[2*hop, 4*bins]`` update matrix and rotate
them (held when ``k >= ready``); build the complex analytic spectra
``U = Ux + i*Uhx`` and ``V`` with their edge reflection past bin 0 and
Nyquist; apply the window, derivative-window and time-weighted-window
stencils; and take the reassignment corrections.

:func:`reassigned_sliding_hop` launches ``csrc/reassigned_hop.cu`` (the
delta products on the tensor cores in 3xTF32, then the slide, stencils and
corrections) for CUDA tensors and runs
:func:`reassigned_sliding_hop_reference` for CPU tensors; on any other
device it raises.  ``reassigned_sliding_hop.launches`` counts
kernel launches.
"""

from __future__ import annotations

import math

import torch

from openmeters_tpu_torch.ops.update_tiles import KC, update_tiles

MAX_TERMS = 4  # cosine-sum window terms the kernel takes (Blackman-Harris)
MAX_ZPF = 2  # zero-padding factors the kernel takes
TILE_EXT = 128  # bins the kernel slides per block, halo included
TILE_HALO = 6  # its halo: MAX_ZPF * (MAX_TERMS - 1)


def hop_tiles(upd: torch.Tensor) -> torch.Tensor:
    """The fused ``[2*hop, 4*bins]`` update matrix as the kernel stages it
    (``ops/update_tiles.py``: parts U_re | U_im | V_re | V_im, bin tiles of
    128 with a halo of 6)."""
    return update_tiles(upd, upd.shape[1] // 4, 4, TILE_EXT, TILE_HALO)


def _extend(xr, xi, hr, hi, jm: int):
    """Complex spectrum ``(xr - hi) + i(xi + hr)`` on bins ``[-jm, half + jm]``.

    Past bin 0 and past Nyquist both one-sided halves reflect hermitian, so
    the combine flips sign on the imaginary parts:
    ``Z[-m] = (xr[m] + hi[m]) + i(hr[m] - xi[m])`` and likewise at
    ``half + m`` with mirror index ``half - m``."""
    er, ei = xr - hi, xi + hr
    if jm == 0:
        return er, ei
    b = xr.shape[-1]
    lo, hi_ = slice(1, jm + 1), slice(b - jm - 1, b - 1)
    left_r = (xr[:, lo] + hi[:, lo]).flip(-1)
    left_i = (hr[:, lo] - xi[:, lo]).flip(-1)
    right_r = (xr[:, hi_] + hi[:, hi_]).flip(-1)
    right_i = (hr[:, hi_] - xi[:, hi_]).flip(-1)
    return torch.cat([left_r, er, right_r], -1), torch.cat([left_i, ei, right_i], -1)


def _column(st, normq, freqb, *, n, zpf, coeffs, inv_2pi, inv_hop, latency_hops):
    """B/D/T stencils and reassignment corrections of one column.

    ``st`` is the eight states; returns ``(freq_hz, time_hops, power)``,
    each ``[S, bins]``."""
    uxr, uxi, uhr, uhi, vxr, vxi, vhr, vhi = st
    bins = uxr.shape[-1]
    jm = zpf * (len(coeffs) - 1)  # stencil offsets scale with the padding
    ur, ui = _extend(uxr, uxi, uhr, uhi, jm)
    vr, vi = _extend(vxr, vxi, vhr, vhi, jm)

    def sl(x, off):
        return x[:, jm + off : jm + off + bins]

    a0 = float(coeffs[0])
    br, bi = a0 * sl(ur, 0), a0 * sl(ui, 0)
    tr, ti = a0 * sl(vr, 0), a0 * sl(vi, 0)
    dr = torch.zeros_like(br)
    di = torch.zeros_like(bi)
    for j in range(1, len(coeffs)):
        half = 0.5 * float(coeffs[j])
        jz = zpf * j
        br = br + half * (sl(ur, -jz) + sl(ur, jz))
        bi = bi + half * (sl(ui, -jz) + sl(ui, jz))
        tr = tr + half * (sl(vr, -jz) + sl(vr, jz))
        ti = ti + half * (sl(vi, -jz) + sl(vi, jz))
        g = math.pi * j * float(coeffs[j]) / n  # D += i*g*(U[k-jz] - U[k+jz])
        dr = dr - g * (sl(ui, -jz) - sl(ui, jz))
        di = di + g * (sl(ur, -jz) - sl(ur, jz))

    pow_raw = br * br + bi * bi
    inv_pow = 1.0 / torch.clamp_min(pow_raw, 1e-38)
    d_omega = -(di * br - dr * bi) * inv_pow
    freq = freqb + d_omega * inv_2pi
    time = (tr * br + ti * bi) * inv_pow * inv_hop - latency_hops
    return freq, time, pow_raw * normq


def reassigned_sliding_hop_reference(
    ready, states, dx, dh, upd, rot_r, rot_i, normq, freqb,
    *, n: int, zpf: int, coeffs: tuple, inv_2pi: float, inv_hop: float,
    latency_hops: float,
):
    """Plain PyTorch version of the hop.  Same arguments and results as
    :func:`reassigned_sliding_hop`."""
    ax = torch.matmul(dx, upd)  # [S, cols, 4*bins]: dU_re | dU_im | dV_re | dV_im
    ah = torch.matmul(dh, upd)
    return slide_reassigned(
        ready, states, ax, ah, rot_r, rot_i, normq, freqb, hop=dx.shape[2] // 2, n=n, zpf=zpf,
        coeffs=coeffs, inv_2pi=inv_2pi, inv_hop=inv_hop, latency_hops=latency_hops,
    )


def slide_reassigned(
    ready, states, ax, ah, rot_r, rot_i, normq, freqb,
    *, hop: int, n: int, zpf: int, coeffs: tuple, inv_2pi: float, inv_hop: float,
    latency_hops: float,
):
    """The plain version's column loop, from the delta products ``ax, ah
    [S, cols, 4*bins]`` of x and hx (dU_re | dU_im | dV_re | dV_im)."""
    bins = states[0].shape[-1]
    cols = ax.shape[1]

    def rotate(re, im):
        return re * rot_r - im * rot_i, re * rot_i + im * rot_r

    st = tuple(states)
    freq, time, power = [], [], []
    for k in range(cols):
        if k < ready:
            dxr, dxi, dvxr, dvxi = ax[:, k].split(bins, dim=-1)
            dhr, dhi, dvhr, dvhi = ah[:, k].split(bins, dim=-1)
            uxr, uxi, uhr, uhi, vxr, vxi, vhr, vhi = st
            st = (
                *rotate(uxr + dxr, uxi + dxi),
                *rotate(uhr + dhr, uhi + dhi),
                *rotate(vxr - hop * uxr + dvxr, vxi - hop * uxi + dvxi),
                *rotate(vhr - hop * uhr + dvhr, vhi - hop * uhi + dvhi),
            )
        f, t, p = _column(
            st, normq, freqb, n=n, zpf=zpf, coeffs=coeffs, inv_2pi=inv_2pi,
            inv_hop=inv_hop, latency_hops=latency_hops,
        )
        freq.append(f)
        time.append(t)
        power.append(p)
    return st, torch.stack(freq, 1), torch.stack(time, 1), torch.stack(power, 1)


def kernel_supports(zpf: int, n_terms: int) -> bool:
    """Whether the CUDA kernel takes this config."""
    return 1 <= n_terms <= MAX_TERMS and 1 <= zpf <= MAX_ZPF


def reassigned_sliding_hop(
    ready, states, dx, dh, upd, rot_r, rot_i, normq, freqb,
    *, n: int, zpf: int, coeffs: tuple, inv_2pi: float, inv_hop: float,
    latency_hops: float, tiles=None,
):
    """One hop of the sliding-analytic reassigned spectrogram.

    Args:
      ready: host int, columns whose slide applies this hop.
      states: eight ``[S, bins]`` float32 states, in the order
        uxr uxi uhr uhi vxr vxi vhr vhi.
      dx, dh: ``[S, cols, 2*hop]`` float32 per-column (new | old) samples of
        the raw signal and of its Hilbert transform.
      upd: ``[2*hop, 4*bins]`` fused delta matrix (U_re | U_im | V_re | V_im).
      rot_r, rot_i, normq, freqb: ``[bins]`` rows; ``normq`` is a quarter
        of the bin normalization, ``freqb`` the bin centre frequencies.
      n: window length; zpf: zero-padding factor (1 or 2); coeffs:
        cosine-sum window coefficients (at most 4).
      tiles: ``hop_tiles(upd)``, which the kernel reads in place of
        ``upd``; made here when not given (``SlidingReassigned`` keeps
        it).  The plain version ignores it.

    Returns ``(new_states, freq, time, power)`` with the per-column
    outputs ``[S, cols, bins]`` float32.
    """
    kw = dict(n=n, zpf=zpf, coeffs=coeffs, inv_2pi=inv_2pi, inv_hop=inv_hop,
              latency_hops=latency_hops)
    dev = states[0].device
    if dev.type == "cpu":
        return reassigned_sliding_hop_reference(
            ready, states, dx, dh, upd, rot_r, rot_i, normq, freqb, **kw
        )
    if dev.type != "cuda":
        raise ValueError(f"reassigned_sliding_hop runs on cpu or cuda tensors, not {dev}")
    if len(states) != 8:
        raise ValueError(f"want 8 states, got {len(states)}")
    s, bins = states[0].shape
    _, cols, two_hop = dx.shape
    hop = two_hop // 2
    tensors = {
        **{f"states[{i}]": (x, (s, bins)) for i, x in enumerate(states)},
        "dx": (dx, (s, cols, 2 * hop)), "dh": (dh, (s, cols, 2 * hop)),
        "upd": (upd, (2 * hop, 4 * bins)),
        "rot_r": (rot_r, (bins,)), "rot_i": (rot_i, (bins,)),
        "normq": (normq, (bins,)), "freqb": (freqb, (bins,)),
    }
    for name, (x, shape) in tensors.items():
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError(f"{name}: want float32 on {dev}, got {x.dtype} on {x.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name}: want contiguous {shape}, got {tuple(x.shape)}")
    if not kernel_supports(zpf, len(coeffs)) or hop == 0 or s > 8 * 65535:
        raise ValueError(
            f"unsupported: cols {cols}, hop {hop}, zpf {zpf}, {len(coeffs)} window terms, "
            f"streams {s}"
        )
    if tiles is None:
        tiles = hop_tiles(upd)
    tile_shape = (-(-bins // (TILE_EXT - 2 * TILE_HALO)), 2, -(-2 * hop // KC), 2 * TILE_EXT * KC)
    if tiles.device != dev or tiles.dtype != torch.float32:
        raise ValueError(f"tiles: want float32 on {dev}, got {tiles.dtype} on {tiles.device}")
    if tuple(tiles.shape) != tile_shape or not tiles.is_contiguous():
        raise ValueError(f"tiles: want contiguous {tile_shape}, got {tuple(tiles.shape)}")

    from openmeters_tpu_torch.ops._build import load_library

    lib = load_library()
    new_states = [torch.empty_like(x) for x in states]
    freq, time, power = (
        torch.empty((s, cols, bins), dtype=torch.float32, device=dev) for _ in range(3)
    )
    terms = len(coeffs)
    halves = [0.5 * float(a) for a in coeffs[1:]] + [0.0] * (MAX_TERMS - terms)
    gs = [math.pi * j * float(coeffs[j]) / n for j in range(1, terms)] + [0.0] * (MAX_TERMS - terms)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.reassigned_hop_launch(
            *(x.data_ptr() for x in states), *(x.data_ptr() for x in new_states),
            dx.data_ptr(), dh.data_ptr(), tiles.data_ptr(),
            rot_r.data_ptr(), rot_i.data_ptr(), normq.data_ptr(), freqb.data_ptr(),
            freq.data_ptr(), time.data_ptr(), power.data_ptr(),
            s, cols, hop, bins, int(ready), zpf, terms,
            float(coeffs[0]), *halves, *gs,
            float(inv_2pi), float(inv_hop), float(latency_hops), stream,
        )
    if rc != 0:
        raise RuntimeError(f"reassigned_sliding_hop kernel launch failed: cudaError {rc}")
    reassigned_sliding_hop.launches += 1
    return tuple(new_states), freq, time, power


reassigned_sliding_hop.launches = 0

"""The per-column reassigned transform: CUDA kernel wrapper and plain version.

Replaces ``openmeters_tpu/ops/pallas_reassigned.py::reassigned_columns``.
Per ``h``-sample raw frame (``h = 2n``, the Hilbert length):

1. the ``h``-point FFT;
2. the analytic selection: DC and the negative bins zeroed, bins
   ``1..h/2`` kept without doubling;
3. the inverse FFT and the centre ``n``-sample crop;
4. ``U = FFT_n(crop)`` and ``V = FFT_n(ramp * crop)``;
5. the window, derivative-window and time-weighted-window stencils, rolled
   circularly over all ``n`` bins of the complex spectra;
6. the reassignment corrections for bins ``[0, n/2]``.

:func:`reassigned_columns` launches ``csrc/reassigned_columns.cu`` for CUDA
tensors and runs :func:`reassigned_columns_reference` for CPU tensors; on
any other device it raises.  ``reassigned_columns.launches`` counts kernel
launches.  :func:`kernel_supports` says, from the config alone, which
shapes the kernel takes.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from openmeters_tpu_torch.ops.block_fft import plan_table
from openmeters_tpu_torch.utils.windows import cosine_sum_window, fft_bin_normalization

MAX_TERMS = 4  # cosine-sum window terms the kernel takes
MAX_H = 16384  # two complex f32 n-point buffers (128 KB) fill one block's shared memory
FFT_STAGES = 4  # radix-2 stages a pass of the kernel's n-point transforms


def kernel_supports(n: int, h: int, n_terms: int = 2) -> bool:
    """Whether the CUDA kernel takes ``n``-sample windows over ``h``-sample
    frames: power-of-two ``n`` with ``h = 2n`` up to ``MAX_H``."""
    return (
        n >= 16 and n & (n - 1) == 0 and h == 2 * n and h <= MAX_H
        and 1 <= n_terms <= MAX_TERMS
    )


def window_norm(coeffs: tuple, n: int) -> np.ndarray:
    """One-sided bin normalization of the cosine-sum window ``coeffs``."""
    return fft_bin_normalization(cosine_sum_window(tuple(coeffs), n), n)


def _consts(n, h, coeffs, sample_rate, hop):
    center = (h - n) // 2
    return dict(
        inv_2pi=sample_rate / (2.0 * np.pi),
        inv_hop=1.0 / hop,
        latency_hops=center * (1.0 / hop),
        bin_hz=sample_rate / n,
    )


def reassigned_columns_reference(
    frames, *, n: int, h: int, coeffs: tuple, sample_rate: float, hop: int
):
    """Plain PyTorch version (``torch.fft``).  Same arguments and results as
    :func:`reassigned_columns`.

    The chain runs in float64 and the results are rounded to float32: an
    f32 FFT chain loses ~1e-6 of the frame's largest bin, which the
    ramp-weighted spectrum V (up to n/2 times U) carries into the time
    correction of weak bins, 0.01 hop at 60 dB below the peak for n = 8192
    (cuFFT, measured on an H100) -- as large as the bar it is held to."""
    center = (h - n) // 2
    bins = n // 2 + 1
    c = _consts(n, h, coeffs, sample_rate, hop)
    spec = torch.fft.rfft(frames.double(), n=h)
    spec[..., 0] = 0.0  # keep bins 1..h/2 without doubling
    full = torch.zeros((*frames.shape[:-1], h), dtype=spec.dtype, device=frames.device)
    full[..., : h // 2 + 1] = spec
    a = torch.fft.ifft(full)[..., center : center + n]
    ramp = torch.arange(n, dtype=torch.float64, device=frames.device) - (n - 1) * 0.5
    u = torch.fft.fft(a)
    v = torch.fft.fft(a * ramp)

    def stencil(x):
        out = float(coeffs[0]) * x
        for j in range(1, len(coeffs)):
            out = out + 0.5 * float(coeffs[j]) * (torch.roll(x, j, -1) + torch.roll(x, -j, -1))
        return out

    b = stencil(u)[..., :bins]
    t = stencil(v)[..., :bins]
    d = torch.zeros_like(u)
    for j in range(1, len(coeffs)):
        g = math.pi * j * float(coeffs[j]) / n  # D += i*g*(U[k-j] - U[k+j])
        d = d + 1j * g * (torch.roll(u, j, -1) - torch.roll(u, -j, -1))
    d = d[..., :bins]
    br, bi, dr, di, tr, ti = b.real, b.imag, d.real, d.imag, t.real, t.imag

    norm = torch.from_numpy(window_norm(tuple(coeffs), n)).to(frames.device, torch.float64)
    pow_raw = br * br + bi * bi
    inv_pow = 1.0 / torch.clamp_min(pow_raw, 1e-38)
    d_omega = -(di * br - dr * bi) * inv_pow
    freq_base = torch.arange(bins, dtype=torch.float64, device=frames.device) * c["bin_hz"]
    freq = freq_base + d_omega * c["inv_2pi"]
    time = (tr * br + ti * bi) * inv_pow * c["inv_hop"] - c["latency_hops"]
    return freq.float(), time.float(), (pow_raw * norm).float()


@functools.lru_cache(maxsize=None)
def _tables(n: int, h: int, coeffs: tuple, device: torch.device):
    """Twiddles ``exp(-2 pi i k / h)``, ``k < h/2`` (computed in float64,
    stored as interleaved float32; the kernel's split step reads them), and
    the bin normalization, on ``device``."""
    k = np.arange(h // 2, dtype=np.float64)
    ang = -2.0 * np.pi * k / h
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    norm = window_norm(coeffs, n)
    return torch.from_numpy(tw).to(device), torch.from_numpy(norm).to(device)


def reassigned_columns(
    frames, *, n: int, h: int, coeffs: tuple, sample_rate: float, hop: int
):
    """Reassigned transform of ``[rows, h]`` float32 raw frames.

    Returns ``(freq_hz, time_offset_hops, power)``, each ``[rows, n/2 + 1]``
    float32.  ``power`` is ``|B|^2`` times the one-sided bin normalization
    (the analytic signal is half-amplitude, so no further factor applies).
    """
    kw = dict(n=n, h=h, coeffs=coeffs, sample_rate=sample_rate, hop=hop)
    dev = frames.device
    if dev.type == "cpu":
        return reassigned_columns_reference(frames, **kw)
    if dev.type != "cuda":
        raise ValueError(f"reassigned_columns runs on cpu or cuda tensors, not {dev}")
    if not kernel_supports(n, h, len(coeffs)):
        raise ValueError(f"unsupported: n {n}, h {h}, {len(coeffs)} window terms")
    if frames.dtype != torch.float32 or frames.dim() != 2 or frames.shape[1] != h:
        raise ValueError(f"frames: want float32 [rows, {h}], got {frames.dtype} {tuple(frames.shape)}")
    if not frames.is_contiguous():
        raise ValueError("frames: want a contiguous tensor")
    rows = frames.shape[0]
    if rows > 2**31 - 1:
        raise ValueError(f"unsupported: {rows} rows")

    from openmeters_tpu_torch.ops._build import load_library

    lib = load_library()
    tw, norm = _tables(n, h, tuple(float(a) for a in coeffs), dev)
    log2n = n.bit_length() - 1
    dif_tw, dit_tw = (plan_table(log2n, FFT_STAGES, dit, dev) for dit in (False, True))
    bins = n // 2 + 1
    freq, time, power = (
        torch.empty((rows, bins), dtype=torch.float32, device=dev) for _ in range(3)
    )
    c = _consts(n, h, coeffs, sample_rate, hop)
    terms = len(coeffs)
    halves = [0.5 * float(a) for a in coeffs[1:]] + [0.0] * (MAX_TERMS - terms)
    gs = [math.pi * j * float(coeffs[j]) / n for j in range(1, terms)] + [0.0] * (MAX_TERMS - terms)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.reassigned_columns_launch(
            frames.data_ptr(), tw.data_ptr(), dif_tw.data_ptr(), dit_tw.data_ptr(), norm.data_ptr(),
            freq.data_ptr(), time.data_ptr(), power.data_ptr(),
            rows, n, terms, float(coeffs[0]), *halves, *gs,
            float(c["bin_hz"]), float(c["inv_2pi"]), float(c["inv_hop"]),
            float(c["latency_hops"]), stream,
        )
    if rc != 0:
        raise RuntimeError(f"reassigned_columns kernel launch failed: cudaError {rc}")
    reassigned_columns.launches += 1
    return freq, time, power


reassigned_columns.launches = 0

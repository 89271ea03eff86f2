"""Recursive (IIR) cascades over batched lanes (port of ``ops/iir.py``).

The loudness path runs the LIFTED block state-space form: a DF2T cascade
is the system ``s' = A s + B x``, ``y = C s + D x``; lifting ``L`` samples
turns the per-sample recurrence into one affine map per block,

    Y_blk = G s + H X_blk        (G [L, n],  H [L, L] lower-triangular)
    s'    = F s + K X_blk        (F = A^L,   K = [A^(L-1) B ... B])

so a hop with ``lift = B`` is four small ``torch.matmul`` products.  The
matrices are built host-side in float64.  The state update runs in float64
too: the RLB high-pass's poles sit near z = 1, so ``F`` and ``K`` cancel
heavily and an f32 update drifts to ~5e-6 of the output's scale within a
few hops, against ~1e-7 with the update in float64 (the state is stored
f32, and ``G s + H X`` stays f32).  :func:`biquad_cascade_scan` is the
plain per-sample recurrence, kept as a cross-check.

The stereometer's and the waveform's three-band crossover runs the
per-sample recurrence, with each biquad's non-finite reset:
:func:`three_band_scan` launches ``csrc/three_band.cu`` for CUDA tensors
and runs :func:`three_band_scan_reference` for CPU tensors.  Its lifted
form would replace that reset with input sanitising, and the stereometer
feeds it raw samples.
"""

from __future__ import annotations

import enum
import functools
import math

import numpy as np
import torch


def biquad_cascade_scan(x, state, coeffs):
    """Cascade of DF2T biquads over time-major ``x [T, lanes...]``, one
    sample at a time (the K-weighting recurrence: no per-sample reset).

    ``state``: ``[n_sections, 2, lanes...]`` DF2T states; ``coeffs``: one
    ``(b0, b1, b2, a1, a2)`` tuple per section.  Returns ``(y, new_state)``.
    """
    z = [[state[i, 0], state[i, 1]] for i in range(len(coeffs))]
    ys = []
    for t in range(x.shape[0]):
        y = x[t]
        for i, (b0, b1, b2, a1, a2) in enumerate(coeffs):
            z0, z1 = z[i]
            out = b0 * y + z0
            z[i] = [b1 * y - a1 * out + z1, b2 * y - a2 * out]
            y = out
        ys.append(y)
    new_state = torch.stack([torch.stack(zi) for zi in z])
    return torch.stack(ys), new_state


def flush_denormal_state(state: torch.Tensor, threshold: float = 1.0e-20):
    """Per-block flush of recursive state below ``threshold`` to zero."""
    return torch.where(torch.abs(state) < threshold, torch.zeros_like(state), state)


def iir_df2t_scan(x, state, b, a):
    """Generic order-N direct-form-II-transposed IIR over time-major ``x
    [T, lanes...]``, one sample at a time.

    ``b``: N+1 numerator taps; ``a``: N feedback taps (a1..aN, a0
    normalized to 1); ``state``: ``[N, lanes...]``.  Returns ``(y,
    new_state)``.  The recurrence of the reference's ``k_weighted``
    (loudness/processor.rs:153-162); no analyzer calls it.
    """
    n = len(a)
    if len(b) != n + 1:
        raise ValueError(f"{len(b)} numerator taps for {n} feedback taps; want {n + 1}")
    z = list(state.unbind(0))
    ys = []
    for t in range(x.shape[0]):
        xt = x[t]
        y = b[0] * xt + z[0]
        z = [b[i + 1] * xt - a[i] * y + (z[i + 1] if i + 1 < n else 0.0) for i in range(n)]
        ys.append(y)
    return torch.stack(ys), torch.stack(z)


def _sos_state_space(sections):
    """Cascade state-space ``(A, B, C, D)`` in float64 for DF2T sections."""
    a_c = None
    for b0, b1, b2, a1, a2 in sections:
        a = np.array([[-a1, 1.0], [-a2, 0.0]])
        b = np.array([b1 - a1 * b0, b2 - a2 * b0])
        c = np.array([1.0, 0.0])
        d = b0
        if a_c is None:
            a_c, b_c, c_c, d_c = a, b, c, d
        else:
            n = a_c.shape[0]
            a_new = np.zeros((n + 2, n + 2))
            a_new[:n, :n] = a_c
            a_new[n:, :n] = np.outer(b, c_c)
            a_new[n:, n:] = a
            b_new = np.concatenate([b_c, b * d_c])
            c_new = np.concatenate([d * c_c, c])
            d_new = d * d_c
            a_c, b_c, c_c, d_c = a_new, b_new, c_new, d_new
    return a_c, b_c, c_c, d_c


@functools.lru_cache(maxsize=None)
def _lifted_mats(sections, lift: int, dtype=np.float32):
    """``(F, K, G, H)`` numpy for an ``lift``-sample block."""
    a, b, c, d = _sos_state_space(sections)
    n = a.shape[0]
    powers = [np.eye(n)]
    for _ in range(lift):
        powers.append(a @ powers[-1])
    f = powers[lift]
    k = np.stack([powers[lift - 1 - i] @ b for i in range(lift)], axis=1)  # [n, L]
    g = np.stack([c @ powers[j] for j in range(lift)], axis=0)  # [L, n]
    h = np.zeros((lift, lift))
    for j in range(lift):
        h[j, j] = d
        for i in range(j):
            h[j, i] = c @ powers[j - 1 - i] @ b
    return tuple(m.astype(dtype) for m in (f, k, g, h))


@functools.lru_cache(maxsize=None)
def _lifted_tensors(sections, lift: int, device: torch.device):
    """float64 ``(F, K)`` for the state update, float32 ``(G, H)``."""
    f, k, _, _ = _lifted_mats(sections, lift, np.float64)
    _, _, g, h = _lifted_mats(sections, lift)
    return tuple(torch.from_numpy(m).to(device) for m in (f, k, g, h))


def lifted_iir_scan(x, state, sections, lift: int = 32):
    """Cascade IIR over ``x [T, lanes...]`` in ``lift``-sample blocks.

    ``state``: ``[n_state, lanes...]`` (2 per section, cascade order — the
    DF2T ``(z0, z1)`` of :func:`biquad_cascade_scan`).  A trailing partial
    block runs with a remainder lift.  Returns ``(y [T, lanes...], state)``.
    """
    t = x.shape[0]
    lift = min(lift, t)
    sections = tuple(tuple(float(v) for v in s) for s in sections)
    lanes = x.shape[1:]
    xm = x.reshape(t, -1)
    s = state.reshape(state.shape[0], -1)
    ys = []
    for start in range(0, t, lift):
        n_blk = min(lift, t - start)
        f, k, g, h = _lifted_tensors(sections, n_blk, x.device)
        x_blk = xm[start : start + n_blk]
        ys.append(g @ s + h @ x_blk)
        s = (f @ s.double() + k @ x_blk.double()).to(torch.float32)
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=0)
    return y.reshape(t, *lanes), s.reshape(state.shape)


# -- the three-band crossover --------------------------------------------------


class FilterKind(enum.Enum):
    LOW_PASS = "low_pass"
    HIGH_PASS = "high_pass"


def biquad_rbj(kind: FilterKind, sample_rate: float, frequency: float) -> np.ndarray:
    """RBJ biquad (Q = 1/sqrt(2)) as ``[b0, b1, b2, a1, a2]`` float64, the
    frequency ratio clamped to [1e-6, 0.49]."""
    ratio = min(max(frequency / sample_rate, 1.0e-6), 0.49)
    w = 2.0 * math.pi * ratio
    sin, cos = math.sin(w), math.cos(w)
    alpha = sin / math.sqrt(2.0)
    if kind is FilterKind.LOW_PASS:
        gain, sign = 1.0 - cos, 1.0
    else:
        gain, sign = 1.0 + cos, -1.0
    inv_a0 = 1.0 / (1.0 + alpha)
    return np.array(
        [
            gain * 0.5 * inv_a0,
            gain * inv_a0 * sign,
            gain * 0.5 * inv_a0,
            -2.0 * cos * inv_a0,
            (1.0 - alpha) * inv_a0,
        ],
        np.float64,
    )


def _crossover_coeffs(sample_rate: float, splits, cascade_n: int):
    """The four crossover filters: LP at the low split, HP at the low
    split, LP at the high split, HP at the high split, each a cascade of
    ``cascade_n`` identical biquads (LR4 when ``cascade_n == 2``)."""
    low, high = splits
    kinds = [
        (FilterKind.LOW_PASS, low),
        (FilterKind.HIGH_PASS, low),
        (FilterKind.LOW_PASS, high),
        (FilterKind.HIGH_PASS, high),
    ]
    return tuple(
        tuple(tuple(biquad_rbj(kind, sample_rate, freq).tolist()) for _ in range(cascade_n))
        for kind, freq in kinds
    )


def three_band_init(lane_shape, cascade_n: int, device=None) -> torch.Tensor:
    """Zero state for :func:`three_band_scan`: ``[4, cascade_n, 2, lanes...]``."""
    return torch.zeros((4, cascade_n, 2, *lane_shape), dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def _crossover_tensor(sample_rate: float, splits, device: torch.device) -> torch.Tensor:
    """``[4, 5]`` float32: each filter's ``(b0, b1, b2, a1, a2)`` (the
    sections of a cascade are identical)."""
    f = _crossover_coeffs(sample_rate, splits, 1)
    return torch.tensor([c[0] for c in f], dtype=torch.float32, device=device)


def _biquad_step(c, x, z0, z1):
    """One DF2T biquad sample on ``[F, lanes]`` with coefficients ``c``, five
    ``[F, 1]`` tensors.  A non-finite output resets the state and emits 0."""
    b0, b1, b2, a1, a2 = c
    y = b0 * x + z0
    nz0 = b1 * x - a1 * y + z1
    nz1 = b2 * x - a2 * y
    ok = torch.isfinite(y)
    return torch.where(ok, y, 0.0), torch.where(ok, nz0, 0.0), torch.where(ok, nz1, 0.0)


def three_band_scan_reference(x, state, sample_rate: float, splits=(200.0, 2000.0),
                              cascade_n: int = 1, cascade_high: bool = False):
    """Plain PyTorch version of :func:`three_band_scan`, one sample at a
    time, the two filters of each stage side by side."""
    t, lanes = x.shape[0], x.shape[1:]
    xm = x.reshape(t, -1).to(torch.float32)
    coeffs = _crossover_tensor(float(sample_rate), tuple(splits), x.device)
    stages = [[coeffs[f0 : f0 + 2, i : i + 1] for i in range(5)] for f0 in (0, 2)]
    z = state.reshape(4, cascade_n, 2, -1)
    # per stage and section: the two filters' (z0, z1), each [2, lanes]
    zs = [[[z[f0 : f0 + 2, j, 0], z[f0 : f0 + 2, j, 1]] for j in range(cascade_n)] for f0 in (0, 2)]

    def stage(st, inp):
        for j in range(cascade_n):
            inp, zs[st][j][0], zs[st][j][1] = _biquad_step(stages[st], inp, *zs[st][j])
        return inp

    out = []
    for i in range(t):
        xt = xm[i]
        low, al = stage(0, xt.expand(2, -1))
        mid, high = stage(1, torch.stack([al, al if cascade_high else xt]))
        out.append(torch.stack([low, mid, high]))
    new_state = torch.stack(
        [torch.stack([torch.stack(zs[st][j], dim=1) for j in range(cascade_n)], dim=1) for st in (0, 1)]
    )  # [stage, filter, cascade, 2, lanes]
    new_state = new_state.reshape(4, cascade_n, 2, *lanes)
    return torch.stack(out).reshape(t, 3, *lanes), new_state


def three_band_scan(x, state, sample_rate: float, splits=(200.0, 2000.0),
                    cascade_n: int = 1, cascade_high: bool = False):
    """Three-way crossover over time-major ``x [T, lanes...]``:
    ``low = LP_lo(x)``, ``al = HP_lo(x)``, ``mid = LP_hi(al)``,
    ``high = HP_hi(al if cascade_high else x)``, every biquad resetting its
    state and emitting 0 on a non-finite output.  ``cascade_n=2,
    cascade_high=True`` is the stereometer's LR4 splitter; ``cascade_n=1,
    cascade_high=False`` the waveform's.

    ``state``: ``[4, cascade_n, 2, lanes...]``.  Returns ``(bands [T, 3,
    lanes...], new_state)``.  Replaces the JAX package's ``lax.scan``
    (``ops/iir.py::three_band_scan``; no ``pallas_call`` there).
    """
    if x.device.type == "cpu":
        return three_band_scan_reference(x, state, sample_rate, splits, cascade_n, cascade_high)
    if x.device.type != "cuda":
        raise ValueError(f"three_band_scan runs on cpu or cuda tensors, not {x.device}")
    t, lanes = x.shape[0], x.shape[1:]
    n = math.prod(lanes)
    want = (4, cascade_n, 2, *lanes)
    for name, v, shape in (("x", x, tuple(x.shape)), ("state", state, want)):
        if v.dtype != torch.float32 or v.device != x.device or not v.is_contiguous():
            raise ValueError(f"three_band_scan {name}: want contiguous float32 on {x.device}")
        if tuple(v.shape) != shape:
            raise ValueError(f"three_band_scan {name}: want {shape}, got {tuple(v.shape)}")
    if cascade_n not in (1, 2):
        raise ValueError(f"three_band_scan: cascade_n {cascade_n}, want 1 or 2")

    from openmeters_tpu_torch.ops._build import load_library

    lib = load_library()
    coeffs = _crossover_tensor(float(sample_rate), tuple(splits), x.device)
    bands = torch.empty((t, 3, *lanes), dtype=torch.float32, device=x.device)
    new_state = torch.empty_like(state)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.three_band_launch(
            x.data_ptr(), state.data_ptr(), coeffs.data_ptr(), bands.data_ptr(),
            new_state.data_ptr(), t, n, cascade_n, int(cascade_high), stream,
        )
    if rc != 0:
        raise RuntimeError(f"three_band kernel launch failed: cudaError {rc}")
    three_band_scan.launches += 1
    return bands, new_state


three_band_scan.launches = 0

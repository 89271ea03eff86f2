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
"""

from __future__ import annotations

import functools

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

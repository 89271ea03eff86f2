"""Host side of ``csrc/fft_block.cuh``: the pass plan of a block FFT and the
twiddle table each plan reads.

A transform of ``2^log2n`` points runs in ``ceil(log2n / maxb)`` passes of
up to ``maxb`` radix-2 stages (:func:`plan_passes`).  A pass of ``r``
stages over groups ``{b + j Q}`` (``Q = 2^l``) needs, at stage ``s``, the
twiddles ``exp(-2 pi i (q + j' Q) / 2^span)`` for the group's offset
``q < Q`` and the stage's ``j' < half``; :func:`plan_twiddles` lays them
out pass by pass, stage by stage, ``j'`` by ``j'``, with ``q`` innermost,
so that the threads of a warp, which hold consecutive ``q``, read
consecutive entries.  Every value is computed in float64 and rounded to
float32 once, so it equals the entry ``exp(-2 pi i k / T)`` of the full
table that the radix-2 passes read.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def pass_bits(log2n: int, i: int, maxb: int) -> int:
    """Stages of pass ``i``: ``log2n`` split into ``ceil(log2n / maxb)``
    passes, the first ones one stage longer where it does not divide."""
    passes = -(-log2n // maxb)
    return log2n // passes + (1 if i < log2n % passes else 0)


def plan_passes(log2n: int, maxb: int, dit: bool) -> list[tuple[int, int]]:
    """``(r, l)`` of each pass: its stages and ``log2 Q`` (decimation in
    frequency: the largest spans first; in time: the smallest first)."""
    out, done = [], 0
    for i in range(-(-log2n // maxb) if log2n > 0 else 0):
        r = pass_bits(log2n, i, maxb)
        out.append((r, done if dit else log2n - done - r))
        done += r
    return out


def plan_twiddles(log2n: int, maxb: int, dit: bool, dtype=np.float32) -> np.ndarray:
    """The twiddles of a plan, ``[entries, 2]`` (re, im), float32 unless
    ``dtype`` says otherwise."""
    ks, spans = [], []
    for r, l in plan_passes(log2n, maxb, dit):
        R, Q = 1 << r, 1 << l
        q = np.arange(Q)
        for s in range(r):
            half = 1 << s if dit else R >> (s + 1)
            span = l + s + 1 if dit else l + r - s
            for jj in range(half):
                ks.append(q + jj * Q)
                spans.append(np.full(Q, span))
    if not ks:
        return np.zeros((1, 2), dtype)
    ang = -2.0 * np.pi * np.concatenate(ks).astype(np.float64) / np.exp2(np.concatenate(spans))
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(dtype)


@functools.lru_cache(maxsize=None)
def plan_table(log2n: int, maxb: int, dit: bool, device: torch.device) -> torch.Tensor:
    """:func:`plan_twiddles` on ``device``."""
    return torch.from_numpy(plan_twiddles(log2n, maxb, dit)).to(device)

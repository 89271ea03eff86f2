"""The card's peaks and the kernels' least work, from shapes alone.

A kernel's least time is the larger of its bytes over the memory rate and
its operations over the dense bf16 tensor-core rate: the highest rate at
which any split-precision scheme that keeps f32 accuracy could run, so a
faster reimplementation of the same work cannot read above 100 %.  Bytes
count each input read once and each output written once.  The counts are
``chip_smoke.py``'s (phases 3 and 6), written from the configuration's
shapes instead of from tensors.
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes a second
PEAK_FLOPS = 989e12  # H100 SXM dense bf16, operations a second
F32 = 4


def least_ms(moved: float, flops: float) -> float:
    return max(moved / PEAK_BYTES, flops / PEAK_FLOPS) * 1e3


def cols_per_hop(block: int, hop: int) -> int:
    return (block - 1) // hop + 1


def sliding_hop_cost(s: int, n: int, hop: int, block: int) -> tuple[float, float]:
    """B1a, one steady hop (every column ready): ``(bytes, operations)``.

    In: the two ``[S, bins]`` f32 states, the ``[S, cols, hop]`` deltas,
    the two ``[hop, bins]`` update matrices, the rotation (two rows), the
    DC correction and the bin normalization.  Out: the two states and the
    ``[S, cols, bins]`` u16 codes.  Operations: two FMA a delta sample and
    bin."""
    bins = n // 2 + 1
    cols = cols_per_hop(block, hop)
    moved = (4 * s * bins * F32 + s * cols * hop * F32 + 2 * hop * bins * F32
             + 4 * bins * F32 + s * cols * bins * 2)
    return float(moved), 4.0 * s * cols * hop * bins


def reassigned_hop_cost(s: int, n: int, hop: int, block: int) -> tuple[float, float]:
    """B2, one steady hop: ``(bytes, operations)``.

    In and out: the eight ``[S, bins]`` f32 states.  In: the two
    ``[S, cols, 2 hop]`` sample deltas (signal, Hilbert transform), the
    ``[2 hop, 4 bins]`` fused update matrix and four ``[bins]`` rows.  Out:
    frequency, time and power ``[S, cols, bins]`` f32.  Operations: eight
    a sample of the signal and of its transform and bin, over the two
    stacked deltas."""
    bins = n // 2 + 1
    cols = cols_per_hop(block, hop)
    moved = (16 * s * bins * F32 + 2 * s * cols * 2 * hop * F32 + 2 * hop * 4 * bins * F32
             + 4 * bins * F32 + 3 * s * cols * bins * F32)
    return float(moved), 2.0 * s * cols * 2 * (2 * hop) * 4 * bins

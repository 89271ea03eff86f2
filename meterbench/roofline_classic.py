"""The least work of the classic spectrogram's per-column kernel
(``classic_columns``), from shapes alone, against the peaks of
``roofline.py``.

One hop of every column of every stream: each stream's ring span that its
columns' windows cover read once (the windows overlap, and the kernel reads
them from the framing ring), the ``[S, cols, bins]`` u16 codes written
once, the window and the bin normalization read once.  Operations: one
``n/2``-point complex FFT a column, ``5 (n/2) log2(n/2)``; the window, the
mean and the split are left out, so the count is a floor.
"""

from __future__ import annotations

import math

from meterbench.roofline import F32, cols_per_hop


def classic_columns_cost(s: int, n: int, hop: int, block: int) -> tuple[float, float]:
    """One steady hop (every column ready): ``(bytes, operations)``."""
    bins = n // 2 + 1
    cols = cols_per_hop(block, hop)
    moved = s * (n + (cols - 1) * hop) * F32 + s * cols * bins * 2 + n * F32 + bins * F32
    return float(moved), 5.0 * (n // 2) * math.log2(n // 2) * s * cols

"""Plain NumPy references of the analyzers, one module an analyzer, found
by the analyzer's name in the configuration.

Each module computes from the pool's samples alone what the analyzer
should report, in float64 (``precision="f64"``) or, for the control, with
every stored operand rounded to TF32 (``precision="tf32"``): samples,
coefficients, windows and transform matrices keep 10 mantissa bits, as
tensor cores hold f32 operands when TF32 is on.  The arithmetic between
them stays float64, so the control understates a true TF32 computation.

Each module gives ``LEAVES`` (the program's meter leaf names it reads, by
field), ``series(...)`` and ``gaps(got, want)``.  The references import
numpy and scipy only.
"""

from __future__ import annotations

import numpy as np


def round_tf32(x) -> np.ndarray:
    """``x`` as float32 rounded to TF32 (10 mantissa bits, round to
    nearest even), returned as float64."""
    a = np.ascontiguousarray(np.asarray(x, np.float32))
    bits = a.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & 0xFFFFE000
    return bits.astype(np.uint32).view(np.float32).astype(np.float64)


def stored(x, precision: str) -> np.ndarray:
    """``x`` as the reference stores it in ``precision``."""
    if precision == "f64":
        return np.asarray(x, np.float64)
    if precision == "tf32":
        return round_tf32(x)
    raise ValueError(f"precision {precision!r}")

"""dB/power conversions and sanitization (port of ``utils/level.py``)."""

from __future__ import annotations

import math

import torch

DB_FLOOR = -140.0
# 10 / ln(10) at f32 precision, as the reference stores it
LN_TO_DB = 4.3429448
DEFAULT_SAMPLE_RATE = 48_000.0
MAX_SAMPLE_RATE = 768_000.0
FLUSH_F32 = 1.0e-20


def power_to_db(power: torch.Tensor, floor: float = DB_FLOOR) -> torch.Tensor:
    """``10*log10(power)`` clamped to ``floor``; non-positive power -> floor.

    Computed as ``ln(power) * LN_TO_DB`` so the reference's rounding applies.
    """
    db = torch.log(torch.clamp_min(power, 1e-45)) * LN_TO_DB
    return torch.where(power > 0.0, torch.clamp_min(db, floor), floor)


def db_to_power(db: torch.Tensor) -> torch.Tensor:
    return torch.exp2(db * (0.1 * math.log2(10.0)))


def db_to_power_host(db: float) -> float:
    """Host scalar variant of :func:`db_to_power`, for config constants."""
    return float(2.0 ** (float(db) * 0.1 * math.log2(10.0)))


def flush_denormal(x: torch.Tensor, threshold: float = FLUSH_F32) -> torch.Tensor:
    """Zero values with magnitude below ``threshold``."""
    return torch.where(torch.abs(x) < threshold, torch.zeros_like(x), x)


def sanitize_negative_db(db: float, default: float) -> float:
    """Finite negative dB or ``default``."""
    return db if math.isfinite(db) and db < 0.0 else default


def sanitize_sample_rate(sample_rate: float) -> float:
    """Finite positive rate clamped to [1, 768k]."""
    if not (
        isinstance(sample_rate, (int, float))
        and math.isfinite(sample_rate)
        and sample_rate > 0.0
    ):
        return DEFAULT_SAMPLE_RATE
    return min(max(float(sample_rate), 1.0), MAX_SAMPLE_RATE)

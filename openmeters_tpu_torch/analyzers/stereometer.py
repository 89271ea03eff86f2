"""Stereometer configuration.

Only the config is ported so far, so that an ``EngineConfig`` means the same
thing in both packages; the analyzer itself is ROADMAP A9 and the engine
refuses a config that enables it.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class StereometerConfig:
    sample_rate: float = 48_000.0
    segment_duration: float = 0.02
    target_sample_count: int = 2_000
    correlation_window: float = 0.05
    analyze_bands: bool = False
    emit_band_points: bool = False
    block_frames: int = 256

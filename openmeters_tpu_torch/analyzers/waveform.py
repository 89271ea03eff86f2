"""Waveform configuration.

Only the config is ported so far, so that an ``EngineConfig`` means the same
thing in both packages; the analyzer itself is ROADMAP A9 and the engine
refuses a config that enables it.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class WaveformConfig:
    sample_rate: float = 48_000.0
    scroll_speed: float = 300.0  # columns per second
    analyze_bands: bool = True
    track_history: bool = False
    block_frames: int = 256

"""Spectrum analyzer configuration.

Only the config is ported so far, so that an ``EngineConfig`` means the same
thing in both packages; the analyzer itself is ROADMAP A8 and the engine
refuses a config that enables it.
"""

from __future__ import annotations

import dataclasses
import enum

from openmeters_tpu_torch.utils.channels import Channel
from openmeters_tpu_torch.utils.windows import WindowKind

DEFAULT_FFT_SIZE = 16_384
DEFAULT_HOP_DIVISOR = 16
DEFAULT_DB_FLOOR = -100.0


class AveragingMode(enum.Enum):
    NONE = "none"
    EXPONENTIAL = "exponential"
    PEAK_HOLD = "peak_hold"


@dataclasses.dataclass(frozen=True)
class SpectrumConfig:
    sample_rate: float = 48_000.0
    fft_size: int = DEFAULT_FFT_SIZE
    hop_size: int = DEFAULT_FFT_SIZE // DEFAULT_HOP_DIVISOR
    window: WindowKind = WindowKind.HANN
    averaging: AveragingMode = AveragingMode.NONE
    exp_factor: float = 0.5
    peak_decay_db_per_s: float = 12.0
    source: Channel = Channel.MID
    secondary_source: Channel = Channel.NONE
    floor_db: float = DEFAULT_DB_FLOOR
    block_frames: int = 256

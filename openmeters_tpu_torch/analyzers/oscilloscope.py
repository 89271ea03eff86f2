"""Oscilloscope configuration.

Only the config is ported so far, so that an ``EngineConfig`` means the same
thing in both packages; the analyzer itself is ROADMAP A10 and the engine
refuses a config that enables it.
"""

from __future__ import annotations

import dataclasses
import enum

from openmeters_tpu_torch.utils.channels import Channel


class TriggerMode(enum.Enum):
    ZERO_CROSSING = "zero_crossing"
    STABLE = "stable"


@dataclasses.dataclass(frozen=True)
class OscilloscopeConfig:
    sample_rate: float = 48_000.0
    segment_duration: float = 0.02
    trigger_mode: TriggerMode = TriggerMode.STABLE
    num_cycles: int = 2
    trigger_source: Channel = Channel.MID
    channel_1: Channel = Channel.MID
    channel_2: Channel = Channel.NONE
    block_frames: int = 256
    trigger_every: int = 1
    snapshot_every: int = 3

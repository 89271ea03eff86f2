"""Channel layouts, stereo fold matrices and BS.1770 channel weights
(port of ``utils/channels.py``), host numpy.

``Channel`` and its stereo projections are carried too: the oscilloscope
projects onto them, and the config dataclasses of the analyzers whose port
is still pending name them in their defaults.
"""

from __future__ import annotations

import enum
import math

import numpy as np

MAX_AUDIO_CHANNELS = 8


class Channel(enum.Enum):
    """Stereo-derived analysis source."""

    LEFT = "left"
    RIGHT = "right"
    MID = "mid"
    SIDE = "side"
    NONE = "none"


def projection_vector(channel: Channel) -> np.ndarray:
    """``[2]`` weights so that ``stereo @ v`` projects onto ``channel``."""
    return {
        Channel.LEFT: np.array([1.0, 0.0], np.float32),
        Channel.RIGHT: np.array([0.0, 1.0], np.float32),
        Channel.MID: np.array([0.5, 0.5], np.float32),
        Channel.SIDE: np.array([0.5, -0.5], np.float32),
        Channel.NONE: np.array([0.0, 0.0], np.float32),
    }[channel]


class ChannelPosition(enum.Enum):
    FRONT_LEFT = "FL"
    FRONT_RIGHT = "FR"
    FRONT_CENTER = "FC"
    LOW_FREQUENCY = "LFE"
    REAR_LEFT = "RL"
    REAR_RIGHT = "RR"
    SIDE_LEFT = "SL"
    SIDE_RIGHT = "SR"
    MONO = "MONO"
    AUX0 = "AUX0"
    AUX1 = "AUX1"
    AUX2 = "AUX2"
    AUX3 = "AUX3"
    AUX4 = "AUX4"
    AUX5 = "AUX5"
    AUX6 = "AUX6"
    AUX7 = "AUX7"
    UNKNOWN = "UNKNOWN"


_P = ChannelPosition

SURROUND = (
    _P.FRONT_LEFT,
    _P.FRONT_RIGHT,
    _P.FRONT_CENTER,
    _P.LOW_FREQUENCY,
    _P.REAR_LEFT,
    _P.REAR_RIGHT,
    _P.SIDE_LEFT,
    _P.SIDE_RIGHT,
)

_AUX = (_P.AUX0, _P.AUX1, _P.AUX2, _P.AUX3, _P.AUX4, _P.AUX5, _P.AUX6, _P.AUX7)


def channel_fallback(channels: int) -> list[ChannelPosition]:
    """Default layout: 1ch mono; 4ch quad (rears in slots 2-3); 5ch
    FL FR FC RL RR; otherwise the SURROUND prefix."""
    channels = min(channels, MAX_AUDIO_CHANNELS)
    positions = [_P.UNKNOWN] * MAX_AUDIO_CHANNELS
    positions[:channels] = list(SURROUND[:channels])
    if channels == 1:
        positions[0] = _P.MONO
    elif channels == 4:
        positions[2:4] = [_P.REAR_LEFT, _P.REAR_RIGHT]
    elif channels == 5:
        positions[3:5] = [_P.REAR_LEFT, _P.REAR_RIGHT]
    return positions


def normalize_positions(channels: int, positions: list[ChannelPosition]) -> list[ChannelPosition]:
    """Duplicates past their first occurrence become UNKNOWN; then every
    UNKNOWN slot takes the first unused of: its fallback slot, the fallback
    layout, the SURROUND layout, AUX0..7."""
    channels = min(channels, MAX_AUDIO_CHANNELS)
    positions = list(positions[:MAX_AUDIO_CHANNELS])
    positions += [_P.UNKNOWN] * (MAX_AUDIO_CHANNELS - len(positions))
    for i in range(channels, MAX_AUDIO_CHANNELS):
        positions[i] = _P.UNKNOWN
    for i in range(channels):
        if positions[i] == _P.UNKNOWN or positions[i] in positions[:i]:
            positions[i] = _P.UNKNOWN

    fallback = channel_fallback(channels)
    for i in range(channels):
        if positions[i] != _P.UNKNOWN:
            continue
        for cand in (fallback[i], *fallback, *SURROUND, *_AUX):
            if cand != _P.UNKNOWN and cand not in positions[:channels]:
                positions[i] = cand
                break
    return positions


def _stereo_indices(channels: int, positions: list[ChannelPosition]) -> tuple[int, int]:
    """Nominal L/R indices when no channel has semantic fold weights."""

    def find(p):
        for i in range(channels):
            if positions[i] == p:
                return i
        return None

    explicit_right = find(_P.FRONT_RIGHT)
    left = find(_P.FRONT_LEFT)
    if left is None:
        left = find(_P.MONO)
    if left is None:
        left = next((i for i in range(channels) if i != explicit_right), 0)
    right = (
        explicit_right
        if (explicit_right is not None and explicit_right != left)
        else None
    )
    if right is None:
        right = next((i for i in range(channels) if i != left), left)
    return left, right


def stereo_matrix(channels: int, positions: list[ChannelPosition]) -> np.ndarray:
    """``[MAX_AUDIO_CHANNELS, 2]`` fold matrix: FL/FR pass through, center,
    rears and sides at 1/sqrt(2), mono feeds both, LFE/aux/unknown drop."""
    channels = min(max(channels, 1), MAX_AUDIO_CHANNELS)
    s = 1.0 / math.sqrt(2.0)
    weights = {
        _P.FRONT_LEFT: (1.0, 0.0),
        _P.FRONT_RIGHT: (0.0, 1.0),
        _P.FRONT_CENTER: (s, s),
        _P.REAR_LEFT: (s, 0.0),
        _P.SIDE_LEFT: (s, 0.0),
        _P.REAR_RIGHT: (0.0, s),
        _P.SIDE_RIGHT: (0.0, s),
        _P.MONO: (1.0, 1.0),
    }
    m = np.zeros((MAX_AUDIO_CHANNELS, 2), np.float32)
    for i in range(channels):
        m[i] = weights.get(positions[i], (0.0, 0.0))

    left_pop = bool(np.any(m[:channels, 0] != 0.0))
    right_pop = bool(np.any(m[:channels, 1] != 0.0))
    if not left_pop and not right_pop:
        li, ri = _stereo_indices(channels, positions)
        m[li, 0] = 1.0
        m[ri, 1] = 1.0
    elif not left_pop:
        m[:, 0] = m[:, 1]
    elif not right_pop:
        m[:, 1] = m[:, 0]
    return m


def channel_weights(positions: list[ChannelPosition]) -> np.ndarray:
    """BS.1770 channel weights ``[MAX_AUDIO_CHANNELS]``: LFE 0,
    rears/sides 1.41, else 1.0."""
    out = np.ones((MAX_AUDIO_CHANNELS,), np.float32)
    for i, p in enumerate(positions[:MAX_AUDIO_CHANNELS]):
        if p == _P.LOW_FREQUENCY:
            out[i] = 0.0
        elif p in (_P.REAR_LEFT, _P.REAR_RIGHT, _P.SIDE_LEFT, _P.SIDE_RIGHT):
            out[i] = 1.41
    return out

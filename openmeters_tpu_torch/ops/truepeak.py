"""True-peak metering by libebur128-compatible polyphase interpolation
(port of ``ops/truepeak.py``).

The 49-tap Hann-windowed sinc has zero endpoints, leaving 48 taps: 4x
oversampling below 96 kHz (12 taps x 3 fractional phases), 2x below
192 kHz (24 taps x 1 phase), the plain sample peak above.  The delay line
is a ``[D-1, lanes...]`` history carried between blocks.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

TRUE_PEAK_TAPS = 48


def _coefficient(j: int, factor: int) -> float:
    offset = j - TRUE_PEAK_TAPS * 0.5
    window = 0.5 * (1.0 - math.cos(2.0 * math.pi * j / TRUE_PEAK_TAPS))
    x = offset * math.pi / factor
    return float(np.float32(window * math.sin(x) / x))


def polyphase_taps(factor: int) -> np.ndarray:
    """``[delay, phases]`` float32 taps of the fractional phases:
    4x ``taps[i, p] = h[4 i + p + 1]`` (i < 12, p < 3); 2x
    ``taps[i, 0] = h[2 i + 1]`` (i < 24)."""
    if factor == 4:
        return np.array(
            [[_coefficient(i * 4 + p + 1, 4) for p in range(3)] for i in range(12)],
            np.float32,
        )
    if factor == 2:
        return np.array([[_coefficient(i * 2 + 1, 2)] for i in range(24)], np.float32)
    raise ValueError(factor)


def oversample_factor(sample_rate: float) -> int:
    if sample_rate < 96_000.0:
        return 4
    if sample_rate < 192_000.0:
        return 2
    return 1


@functools.lru_cache(maxsize=None)
def _flipped_taps(factor: int, device: torch.device) -> torch.Tensor:
    # row m multiplies xx[n + m] == x[n - (D - 1 - m)]
    return torch.from_numpy(polyphase_taps(factor)[::-1].copy()).to(device)


@dataclasses.dataclass(frozen=True)
class TruePeakKernel:
    sample_rate: float

    @property
    def factor(self) -> int:
        return oversample_factor(self.sample_rate)

    @property
    def delay(self) -> int:
        return {4: 12, 2: 24, 1: 0}[self.factor]

    def init(self, lane_shape: tuple[int, ...], device=None) -> torch.Tensor:
        return torch.zeros(
            (max(self.delay - 1, 0), *lane_shape), dtype=torch.float32, device=device
        )

    def process_block(self, carry, x, reset_mask=None):
        """Peak of ``|x|`` and of the interpolated phases over one
        ``[T, lanes...]`` block.  Returns ``(new_history, peak [lanes...])``."""
        t = x.shape[0]
        sample_peak = torch.amax(torch.abs(x), dim=0)
        if self.factor == 1:
            return carry, sample_peak
        if reset_mask is not None:
            carry = torch.where(reset_mask, 0.0, carry)
        d = self.delay
        xx = torch.cat([carry, x], dim=0)  # [T + D - 1, lanes...]
        # y_p[n] = sum_i taps[i, p] x[n - i], as one matmul over D-sample
        # windows of the history-extended block
        windows = xx.unfold(0, d, 1)  # [T, lanes..., D]
        y = windows @ _flipped_taps(self.factor, x.device)  # [T, lanes..., P]
        interp_peak = torch.amax(torch.abs(y), dim=(0, -1))
        return xx[t:].clone(), torch.maximum(sample_peak, interp_peak)

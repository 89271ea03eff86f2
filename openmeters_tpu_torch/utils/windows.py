"""FFT analysis windows and bin normalization (port of ``utils/windows.py``).

Host-side numpy: periodic (DFT-even) cosine-sum windows.
"""

from __future__ import annotations

import enum
import functools

import numpy as np


class WindowKind(enum.Enum):
    RECTANGULAR = "rectangular"
    HANN = "hann"
    HAMMING = "hamming"
    BLACKMAN = "blackman"
    BLACKMAN_HARRIS = "blackman_harris"

    @property
    def cosine_coefficients(self) -> tuple[float, ...]:
        return {
            WindowKind.RECTANGULAR: (1.0,),
            WindowKind.HANN: (0.5, -0.5),
            WindowKind.HAMMING: (25.0 / 46.0, -21.0 / 46.0),
            WindowKind.BLACKMAN: (0.42, -0.5, 0.08),
            WindowKind.BLACKMAN_HARRIS: (0.35875, -0.48829, 0.14128, -0.01168),
        }[self]


@functools.lru_cache(maxsize=None)
def window_coefficients(kind: WindowKind, length: int) -> np.ndarray:
    """Periodic cosine-sum window of ``length`` samples, float32."""
    if length <= 0:
        return np.zeros((0,), np.float32)
    if length == 1 or kind is WindowKind.RECTANGULAR:
        return np.ones((length,), np.float32)
    n = np.arange(length, dtype=np.float64)
    phi = n * (2.0 * np.pi / length)
    out = np.zeros((length,), np.float64)
    for k, c in enumerate(kind.cosine_coefficients):
        out += c * np.cos(phi * k)
    return out.astype(np.float32)


def fft_bin_normalization(window: np.ndarray, fft_size: int) -> np.ndarray:
    """Coherent-gain power normalization per one-sided rFFT bin: DC and
    Nyquist scale by ``(1/sum(w))^2``, AC bins by 4x that."""
    bins = fft_size // 2 + 1
    wsum = float(np.sum(window, dtype=np.float32))
    if abs(wsum) > np.finfo(np.float32).eps:
        inv = 1.0 / wsum
    elif fft_size > 0:
        inv = 1.0 / fft_size
    else:
        inv = 0.0
    dc = np.float32(inv) * np.float32(inv)
    norms = np.full((bins,), 4.0 * dc, np.float32)
    norms[0] = dc
    if fft_size % 2 == 0 and bins > 1:
        norms[-1] = dc
    return norms

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
    return cosine_sum_window(kind.cosine_coefficients, length)


def cosine_sum_window(coeffs: tuple, length: int) -> np.ndarray:
    """``sum_k coeffs[k] cos(2 pi k i / length)``, float32."""
    phi = np.arange(length, dtype=np.float64) * (2.0 * np.pi / length)
    out = np.zeros((length,), np.float64)
    for k, c in enumerate(coeffs):
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


# -- reassigned-spectrogram window helpers (``analyzers/spectrogram.py``) ---


def hilbert_len_for(window_size: int) -> int:
    """``(2 * window).next_power_of_two()``: the analytic-signal length."""
    n = max(window_size * 2, 2)
    return 1 << (n - 1).bit_length()


def derivative_window(window: np.ndarray) -> np.ndarray:
    """Spectral-derivative window dh/dn via FFT."""
    n = len(window)
    if n <= 1:
        return np.zeros(n, np.float32)
    spec = np.fft.fft(window.astype(np.float64))
    k = np.arange(n)
    omega = (2.0 * np.pi / n) * np.where(k > n // 2, k - n, k).astype(np.float64)
    omega[0] = 0.0
    if n % 2 == 0:
        omega[n // 2] = 0.0
    dspec = 1j * omega * spec
    dspec[0] = 0.0
    if n % 2 == 0:
        dspec[n // 2] = 0.0
    return np.real(np.fft.ifft(dspec)).astype(np.float32)


def time_weighted_window(window: np.ndarray) -> np.ndarray:
    """``(i - center) * w[i]`` with ``center = (len - 1) / 2``."""
    center = (len(window) - 1) * 0.5
    return ((np.arange(len(window)) - center) * window.astype(np.float64)).astype(
        np.float32
    )


def reassigned_power_scale(window: np.ndarray, fft_size: int) -> float:
    """Coherent-gain/ENBW correction for splat accumulation:
    ``sum(w)^2 / (fft_size * sum(w^2))``."""
    w = window.astype(np.float64)
    s, ss = np.sum(w), np.sum(w * w)
    return float(s * s / (fft_size * ss))

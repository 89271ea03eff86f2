"""Display-side frequency scales (linear / log-asinh / ERB); a copy of the
JAX package's ``utils/frequency.py``.

Reference parity: ``src/util/audio/frequency.rs``.  Exposed headlessly so
downstream renderers can map bins to screen positions; works on numpy
arrays.
"""

from __future__ import annotations

import enum

import numpy as np

LOG_KNEE_HZ = 20.0  # reference frequency.rs:14


class FrequencyScale(enum.Enum):
    LINEAR = "linear"
    LOGARITHMIC = "logarithmic"
    ERB = "erb"

    def scale(self, hz):
        hz = np.asarray(hz, np.float32)
        if self is FrequencyScale.LINEAR:
            return hz
        if self is FrequencyScale.LOGARITHMIC:
            return np.arcsinh(hz / LOG_KNEE_HZ)
        return 21.4 * np.log10(1.0 + hz / 228.8)

    def unscale(self, x):
        x = np.asarray(x, np.float32)
        if self is FrequencyScale.LINEAR:
            return x
        if self is FrequencyScale.LOGARITHMIC:
            return LOG_KNEE_HZ * np.sinh(x)
        return 228.8 * (np.power(10.0, x / 21.4) - 1.0)

    def freq_at(self, lo_hz: float, hi_hz: float, t):
        """Frequency at normalized position ``t`` in [0,1] (frequency.rs:17-19)."""
        a, b = self.scale(lo_hz), self.scale(hi_hz)
        return self.unscale(a + (b - a) * np.asarray(t, np.float32))

    def pos_of(self, lo_hz: float, hi_hz: float, freq_hz):
        """Normalized position of ``freq_hz`` (frequency.rs:21-24)."""
        a, b = self.scale(lo_hz), self.scale(hi_hz)
        return (self.scale(freq_hz) - a) / max(b - a, 1e-6)

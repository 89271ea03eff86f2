"""Meter analyzers: BS.1770 loudness, the spectrogram, the spectrum, the
oscilloscope, the stereometer and the waveform, each in its module."""

from openmeters_tpu_torch.analyzers.loudness import (  # noqa: F401
    LoudnessAnalyzer,
    LoudnessConfig,
    LoudnessSnapshot,
)
from openmeters_tpu_torch.analyzers.spectrogram import (  # noqa: F401
    ClassicColumns,
    SpectrogramAnalyzer,
    SpectrogramConfig,
)

"""Meter analyzers: BS.1770 loudness and the classic spectrogram are ported;
the other analyzers carry their config only."""

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

"""PyTorch/CUDA port of the openmeters_tpu meter engine.

The JAX package ``openmeters_tpu`` is the reference this package is held
against; this one imports ``torch``, numpy and the standard library only.
It mirrors the reference layout (``utils/``, ``ops/``, ``analyzers/``,
``engine/``, ``api.py``) so each module's counterpart is easy to find.

Ported so far: the flagship meter path — BS.1770 loudness plus the classic
sliding-DFT spectrogram — with the sliding-DFT hop as a hand-written CUDA
kernel (``ops/sliding_hop.py``, ``csrc/sliding_hop.cu``).
"""

from openmeters_tpu_torch.api import AnalysisSession, analyze  # noqa: F401
from openmeters_tpu_torch.engine import (  # noqa: F401
    EngineConfig,
    MeterEngine,
    StreamMeta,
)

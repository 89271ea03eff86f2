"""PyTorch/CUDA port of the openmeters_tpu meter engine.

The JAX package ``openmeters_tpu`` is the reference this package is held
against; this one imports ``torch``, numpy and the standard library only.
It mirrors the reference layout (``utils/``, ``ops/``, ``analyzers/``,
``engine/``, ``api.py``) so each module's counterpart is easy to find.

All six analyzers, the engine, the batch API, reconfiguration, the carry
checkpoint and the serving loop (``serve.py`` over the native transport in
``ingest/``) are ported.  Each TPU kernel on their paths is a hand-written
CUDA kernel in ``csrc/`` behind a wrapper in ``ops/`` that runs its plain
PyTorch version for CPU tensors.
"""

from openmeters_tpu_torch.api import AnalysisSession, analyze  # noqa: F401
from openmeters_tpu_torch.engine import (  # noqa: F401
    EngineConfig,
    MeterEngine,
    StreamMeta,
)

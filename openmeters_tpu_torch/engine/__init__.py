from openmeters_tpu_torch.engine.engine import (  # noqa: F401
    EngineConfig,
    MeterEngine,
    StreamMeta,
    scaled_block_frames,
)

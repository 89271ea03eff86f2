from openmeters_tpu_torch.engine.engine import (  # noqa: F401
    EngineConfig,
    MeterEngine,
    StreamMeta,
    scaled_block_frames,
)
from openmeters_tpu_torch.engine.sharding import (  # noqa: F401
    STREAM_AXIS,
    StreamMesh,
    make_mesh,
    make_multihost_mesh,
    sharded_step,
)

"""Device mesh and sharding rules (``torch.distributed``)."""

from k210_yolo_framework_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    SPACE_AXIS,
    batch_sharding,
    image_sharding,
    make_mesh,
    param_shardings,
    replicated,
)

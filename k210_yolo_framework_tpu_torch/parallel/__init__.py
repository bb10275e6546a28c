"""Device mesh and sharding rules (``torch.distributed``)."""

from k210_yolo_framework_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    SPACE_AXIS,
    batch_sharding,
    data_group,
    data_rank,
    host_group,
    image_sharding,
    init_world,
    make_mesh,
    mean_over_data,
    param_shardings,
    replicated,
    require_data_parallel,
    slot_range,
    sum_over_data,
)

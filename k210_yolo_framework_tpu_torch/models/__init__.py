"""Model zoo (train and eval): yolo_mobilev1 so far."""

from k210_yolo_framework_tpu_torch.models.yolonet import (  # noqa: F401
    NETWORKS,
    YoloNet,
    build_network,
)

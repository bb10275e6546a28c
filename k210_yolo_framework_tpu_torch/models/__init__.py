"""Model zoo (train and eval): yolo_mobilev1, yolo_mobilev2, tiny_yolo and
the darknet53 yolo."""

from k210_yolo_framework_tpu_torch.models.yolonet import (  # noqa: F401
    NETWORKS,
    YoloNet,
    build_network,
)

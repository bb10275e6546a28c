"""Anchor generation (kmeans with the 1 - IoU distance)."""

from k210_yolo_framework_tpu_torch.anchors.kmeans import (  # noqa: F401
    generate_anchors,
    kmeans_iou,
    letterbox_correct_boxes,
)

"""Frozen configuration specs, shared with the JAX package.

``k210_yolo_framework_tpu.config`` imports only numpy (and the JAX package's
``__init__`` imports only that module), so the port re-exports it instead
of keeping a copy: ``YoloSpec``, ``voc_spec`` and the training
hyperparameters ``TrainConfig``.
"""

from k210_yolo_framework_tpu.config import (  # noqa: F401
    VOC_ANCHORS,
    TrainConfig,
    YoloSpec,
    voc_spec,
)

__all__ = ["VOC_ANCHORS", "TrainConfig", "YoloSpec", "voc_spec"]

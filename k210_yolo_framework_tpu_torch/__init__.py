"""PyTorch/CUDA port of the YOLOv3 framework, for an NVIDIA H100.

The JAX package ``k210_yolo_framework_tpu`` is the reference this package is
held against.  Module names mirror it so each counterpart is easy to find:

    config          re-export of the numpy-only ``YoloSpec`` / ``voc_spec``
    ops             letterbox, NMS result type, greedy selection, and the
                    fused decode+NMS head (plain torch + a CUDA kernel)
    models          yolo_mobilev1 forward (eval) as ``nn.Module``s
    training        weight bridge between the native h5 layout and torch
    inference       ``Predictor``: batched and single-image serving
    csrc            hand-written CUDA C++ kernels (built at first use)

Only ``torch`` and numpy are imported here; nothing of JAX or flax.
"""

from k210_yolo_framework_tpu_torch.config import (  # noqa: F401
    VOC_ANCHORS,
    YoloSpec,
    voc_spec,
)

__all__ = ["VOC_ANCHORS", "YoloSpec", "voc_spec"]

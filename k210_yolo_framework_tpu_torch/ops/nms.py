"""Fixed-size NMS result, counterpart of ``k210_yolo_framework_tpu.ops.nms``."""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["NmsResult"]


class NmsResult(NamedTuple):
    """Fixed-size detections, class-major: entry ``c * max_out + k`` is the
    k-th kept box of class c.  Batched results carry a leading [B]."""

    boxes: torch.Tensor    # [B, C * max_out, 4] yxyx pixels
    scores: torch.Tensor   # [B, C * max_out]
    classes: torch.Tensor  # [B, C * max_out] int32
    valid: torch.Tensor    # [B, C * max_out] bool

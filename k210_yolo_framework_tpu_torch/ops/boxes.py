"""Box geometry primitives, batched over any leading dimensions.

Counterpart of ``k210_yolo_framework_tpu/ops/boxes.py``: the centre-aligned
IoU of anchor assignment, the broadcast IoU of the loss's ignore mask, and
the centre <-> corner transforms, in the same operation order.
"""

from __future__ import annotations

import torch

__all__ = ["centered_iou", "iou_xywh", "center_to_corner", "corner_to_center"]


def centered_iou(wh_a: torch.Tensor, wh_b: torch.Tensor) -> torch.Tensor:
    """IoU of (w, h) boxes [..., 2] with both centres at the origin; the
    leading dimensions broadcast."""
    a_maxes = wh_a / 2.0
    b_maxes = wh_b / 2.0
    inner_maxes = torch.minimum(a_maxes, b_maxes)
    inner_mins = torch.maximum(-a_maxes, -b_maxes)
    inner_wh = torch.clamp_min(inner_maxes - inner_mins, 0.0)
    inner_area = inner_wh[..., 0] * inner_wh[..., 1]
    s1 = wh_a[..., 0] * wh_a[..., 1]
    s2 = wh_b[..., 0] * wh_b[..., 1]
    return inner_area / (s1 + s2 - inner_area)


def iou_xywh(pred_xy: torch.Tensor, pred_wh: torch.Tensor,
             valid_xy: torch.Tensor, valid_wh: torch.Tensor) -> torch.Tensor:
    """IoU of every predicted box ``pred_*`` [..., 2] against every box
    ``valid_*`` [n, 2]; returns [..., n]."""
    b1_xy = pred_xy[..., None, :]
    b1_wh = pred_wh[..., None, :]
    b1_half = b1_wh / 2.0
    b1_mins, b1_maxes = b1_xy - b1_half, b1_xy + b1_half

    b2_half = valid_wh / 2.0
    b2_mins, b2_maxes = valid_xy - b2_half, valid_xy + b2_half

    inter_mins = torch.maximum(b1_mins, b2_mins)
    inter_maxes = torch.minimum(b1_maxes, b2_maxes)
    inter_wh = torch.clamp_min(inter_maxes - inter_mins, 0.0)
    inter_area = inter_wh[..., 0] * inter_wh[..., 1]
    b1_area = b1_wh[..., 0] * b1_wh[..., 1]
    b2_area = valid_wh[..., 0] * valid_wh[..., 1]
    return inter_area / (b1_area + b2_area - inter_area)


def _pixel_scale(in_hw, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([in_hw[1], in_hw[0], in_hw[1], in_hw[0]],
                        dtype=like.dtype, device=like.device)


def center_to_corner(boxes: torch.Tensor, in_hw=None) -> torch.Tensor:
    """[..., 4] xywh -> xyxy; scaled to pixels when ``in_hw`` is given."""
    x, y, w, h = boxes.unbind(-1)
    out = torch.stack([x - w / 2.0, y - h / 2.0, x + w / 2.0, y + h / 2.0],
                      dim=-1)
    if in_hw is not None:
        out = out * _pixel_scale(in_hw, out)
    return out


def corner_to_center(boxes: torch.Tensor, in_hw=None) -> torch.Tensor:
    """[..., 4] xyxy -> xywh; from pixels when ``in_hw`` is given."""
    if in_hw is not None:
        boxes = boxes / _pixel_scale(in_hw, boxes)
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) / 2.0, (y1 + y2) / 2.0, x2 - x1, y2 - y1],
                       dim=-1)

"""Detection head decode: raw logits -> image-space boxes and per-class
scores, the first stage of the two-stage head (``decode_outputs`` ->
``ops/nms_pallas.batched_nms_pallas`` or ``ops/nms.batched_nms``).

Counterpart of ``k210_yolo_framework_tpu/ops/decode.py``:

  * score = sigmoid(class) * sigmoid(conf), or with ``class_softmax`` the
    K210 region layer's softmax over the classes times sigmoid(conf);
  * xy and wh through ``ops/codec.xywh_grid_to_all`` (sigmoid + cell
    offset, exp * anchor);
  * the letterbox undone by ``ops/letterbox.correct_boxes`` into yxyx
    pixels of each original image;
  * the layers concatenated in order.

The JAX functions decode one image (and are vmapped over a batch); these
take the batch: ``pred [B, h, w, a, 5 + C]`` with ``image_hws [B, 2]``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from k210_yolo_framework_tpu_torch.config import YoloSpec
from k210_yolo_framework_tpu_torch.ops.codec import xywh_grid_to_all
from k210_yolo_framework_tpu_torch.ops.letterbox import correct_boxes

__all__ = ["decode_layer", "decode_outputs", "num_candidates"]


def num_candidates(spec: YoloSpec) -> int:
    """Boxes over all layers (7*10*3 + 14*20*3 = 1050 for the VOC spec)."""
    return sum(h * w * spec.nanchors for h, w in spec.out_hws)


def decode_layer(pred: torch.Tensor, layer: int, spec: YoloSpec,
                 image_hws: torch.Tensor, class_softmax: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode one layer's raw output [B, h, w, a, 5 + C] for images of size
    ``image_hws [B, 2]`` -> (yxyx boxes [B, h*w*a, 4] in original-image
    pixels, scores [B, h*w*a, C]), fp32."""
    pred = pred.to(torch.float32)
    conf = torch.sigmoid(pred[..., 4:5])
    if class_softmax:
        scores = torch.softmax(pred[..., 5:], dim=-1) * conf
    else:
        scores = torch.sigmoid(pred[..., 5:]) * conf
    xy_all, wh_all = xywh_grid_to_all(pred[..., 0:2], pred[..., 2:4], layer,
                                      spec)
    boxes = correct_boxes(xy_all, wh_all, spec.in_hw, image_hws.to(pred.device))
    bsz = pred.shape[0]
    return (boxes.reshape(bsz, -1, 4),
            scores.reshape(bsz, -1, spec.class_num))


def decode_outputs(preds: Sequence[torch.Tensor], spec: YoloSpec,
                   image_hws: torch.Tensor, class_softmax: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode and concatenate all output layers -> boxes [B, N, 4], scores
    [B, N, C] with N = ``num_candidates(spec)``."""
    all_boxes: List[torch.Tensor] = []
    all_scores: List[torch.Tensor] = []
    for layer, p in enumerate(preds):
        b, s = decode_layer(p, layer, spec, image_hws, class_softmax)
        all_boxes.append(b)
        all_scores.append(s)
    return torch.cat(all_boxes, dim=1), torch.cat(all_scores, dim=1)

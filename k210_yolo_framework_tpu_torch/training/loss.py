"""The five-term YOLO loss with IoU ignore masks, batched.

Counterpart of ``k210_yolo_framework_tpu/training/loss.py``, term for term
and in the same operation order:

    xy    BCE-with-logits vs grid truth  * obj * (2 - w*h)          / B
    wh    MSE in log space               * obj * (2 - w*h) * w_wh   / B
    obj   BCE                            * obj * w_obj              / B
    noobj BCE                 * (1-obj) * ignore_mask * w_noobj     / B
    cls   BCE                            * obj                      / B

The ignore mask takes, per image, the (at most 64) label rows of highest
confidence as the gt set; it carries no gradient and is computed without
one.  Predictions are cast to fp32 first.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from k210_yolo_framework_tpu_torch.config import YoloSpec
from k210_yolo_framework_tpu_torch.models.layers import Conv
from k210_yolo_framework_tpu_torch.ops.boxes import iou_xywh
from k210_yolo_framework_tpu_torch.ops.codec import (
    MAX_BOXES,
    top_k_first,
    xywh_all_to_grid,
    xywh_grid_to_all,
)

__all__ = ["yolo_layer_loss", "yolo_loss_layers", "yolo_loss",
           "calc_ignore_mask", "l2_kernels", "l2_penalty"]

_L2_SCALE = 5e-4  # keras kernel_regularizer=l2(5e-4) in the reference


def _bce_logits(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``tf.nn.sigmoid_cross_entropy_with_logits``, with JAX's gradients at
    a logit of exactly 0: ``torch.maximum`` splits the tie as
    ``jnp.maximum`` does, and the ``where`` form of |x| has slope 1 there,
    as ``jnp.abs`` (``torch.abs`` has 0)."""
    zero = logits.new_zeros(())
    return (torch.maximum(logits, zero) - logits * labels
            + torch.log1p(torch.exp(-torch.where(logits >= 0, logits,
                                                 -logits))))


@torch.no_grad()
def calc_ignore_mask(y_true: torch.Tensor, pred_xy_all: torch.Tensor,
                     pred_wh_all: torch.Tensor, obj_thresh: float,
                     iou_thresh: float,
                     max_boxes: int = MAX_BOXES) -> torch.Tensor:
    """y_true [B, h, w, a, 5+C], pred_*_all [B, h, w, a, 2] at image scale
    -> [B, h, w, a, 1] float mask: 1 where no gt box of the image overlaps
    the prediction by ``iou_thresh`` or more."""
    bsz = y_true.shape[0]
    conf = y_true[..., 4].reshape(bsz, -1)
    top_conf, top_i = top_k_first(conf, min(max_boxes, conf.shape[1]))
    gt = torch.gather(y_true[..., 0:4].reshape(bsz, -1, 4), 1,
                      top_i[..., None].expand(-1, -1, 4))           # [B, k, 4]
    valid = top_conf > obj_thresh                                   # [B, k]
    lead = (bsz,) + (1,) * (pred_xy_all.ndim - 2)
    iou = iou_xywh(pred_xy_all, pred_wh_all,
                   gt[..., 0:2].reshape(lead + gt.shape[1:2] + (2,)),
                   gt[..., 2:4].reshape(lead + gt.shape[1:2] + (2,)))
    iou = torch.where(valid.reshape(lead + valid.shape[1:]), iou,
                      iou.new_zeros(()))
    best_iou = torch.amax(iou, dim=-1, keepdim=True)
    return (best_iou < iou_thresh).to(torch.float32)


def yolo_layer_loss(y_true: torch.Tensor, y_pred: torch.Tensor, layer: int,
                    spec: YoloSpec, batch_size: int, obj_thresh: float,
                    iou_thresh: float, obj_weight: float, noobj_weight: float,
                    wh_weight: float) -> torch.Tensor:
    """The loss of one output layer, batched [B, h, w, a, 5+C] inputs."""
    y_true = y_true.to(torch.float32)
    y_pred = y_pred.to(torch.float32)

    grid_pred_xy = y_pred[..., 0:2]
    grid_pred_wh = y_pred[..., 2:4]
    pred_conf = y_pred[..., 4:5]
    pred_cls = y_pred[..., 5:]

    all_true_xy = y_true[..., 0:2]
    all_true_wh = y_true[..., 2:4]
    true_conf = y_true[..., 4:5]
    true_cls = y_true[..., 5:]

    obj_mask = true_conf                         # soft mask
    obj_mask_bool = y_true[..., 4] > obj_thresh

    pred_xy_all, pred_wh_all = xywh_grid_to_all(grid_pred_xy, grid_pred_wh,
                                                layer, spec)
    ignore_mask = calc_ignore_mask(y_true, pred_xy_all, pred_wh_all,
                                   obj_thresh, iou_thresh)

    grid_true_xy, grid_true_wh = xywh_all_to_grid(all_true_xy, all_true_wh,
                                                  layer, spec)
    # log(0) = -inf in empty cells never reaches the loss
    grid_true_wh = torch.where(obj_mask_bool[..., None], grid_true_wh,
                               grid_true_wh.new_zeros(()))

    coord_weight = 2.0 - all_true_wh[..., 0:1] * all_true_wh[..., 1:2]

    xy_loss = torch.sum(obj_mask * coord_weight
                        * _bce_logits(grid_true_xy, grid_pred_xy)) / batch_size
    wh_loss = torch.sum(obj_mask * coord_weight * wh_weight
                        * torch.square(grid_true_wh - grid_pred_wh)) \
        / batch_size
    obj_loss = obj_weight * torch.sum(
        obj_mask * _bce_logits(true_conf, pred_conf)) / batch_size
    noobj_loss = noobj_weight * torch.sum(
        (1.0 - obj_mask) * ignore_mask
        * _bce_logits(true_conf, pred_conf)) / batch_size
    cls_loss = torch.sum(obj_mask * _bce_logits(true_cls, pred_cls)) \
        / batch_size
    return obj_loss + noobj_loss + cls_loss + xy_loss + wh_loss


def yolo_loss_layers(y_trues: Sequence[torch.Tensor],
                     y_preds: Sequence[torch.Tensor], spec: YoloSpec,
                     batch_size: int, obj_thresh: float, iou_thresh: float,
                     obj_weight: float, noobj_weight: float,
                     wh_weight: float) -> List[torch.Tensor]:
    """Per-output-layer losses (the reference's ``l1_loss``, ``l2_loss``)."""
    return [yolo_layer_loss(yt, yp, l, spec, batch_size, obj_thresh,
                            iou_thresh, obj_weight, noobj_weight, wh_weight)
            for l, (yt, yp) in enumerate(zip(y_trues, y_preds))]


def yolo_loss(y_trues: Sequence[torch.Tensor],
              y_preds: Sequence[torch.Tensor], spec: YoloSpec,
              batch_size: int, obj_thresh: float, iou_thresh: float,
              obj_weight: float, noobj_weight: float,
              wh_weight: float) -> torch.Tensor:
    """Total loss: the sum over output layers."""
    total = 0.0
    for term in yolo_loss_layers(y_trues, y_preds, spec, batch_size,
                                 obj_thresh, iou_thresh, obj_weight,
                                 noobj_weight, wh_weight):
        total = total + term
    return total


def l2_kernels(net: nn.Module):
    """[(module name, kernel)] of the :class:`Conv` modules under a scope
    named ``dark_conv*`` (the head's DarknetConvBN convs and output
    convs), sorted by name as the JAX package walks its params.  Selected
    by module type: a conv kernel and a BN scale are both named
    ``weight``, and biases are left out."""
    return sorted(((name, mod.weight) for name, mod in net.named_modules()
                   if isinstance(mod, Conv)
                   and any("dark_conv" in part for part in name.split("."))),
                  key=lambda item: item[0])


def l2_penalty(net: nn.Module) -> torch.Tensor:
    """keras ``l2(5e-4)`` on the Darknet convs: ``5e-4 * sum(k^2)`` over
    :func:`l2_kernels`."""
    total = 0.0
    for _, kernel in l2_kernels(net):
        total = total + torch.sum(torch.square(kernel))
    return _L2_SCALE * total

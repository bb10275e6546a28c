"""Label codecs: gt boxes <-> grid labels, grid <-> image coordinates.

Counterpart of ``k210_yolo_framework_tpu/ops/codec.py``.  Encoding keeps the
reference loop's semantics (``Helper.box_to_label``): each box picks its
(layer, anchor) by the best centre-aligned IoU (first index on ties) and its
cell by ``floor(xy * grid_wh)``; within one (cell, anchor) slot a later box
overwrites the payload (xywh clipped to [1e-8, 1], conf 1) while the class
bits accumulate.

JAX writes with ``mode="drop"`` scatters, which drop an out-of-range index
(a box with x == 1.0 has cell index ``w``).  ``index_put_`` has no drop
mode, so here a row that must not write is sent to one spare slot past the
end of the flattened grid, which is cut off afterwards.  Every real slot
gets at most one payload writer (the last-writer collision test), and the
class writes all store 1.0, so the result does not depend on write order.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from k210_yolo_framework_tpu_torch.config import YoloSpec
from k210_yolo_framework_tpu_torch.ops.boxes import centered_iou

__all__ = ["MAX_BOXES", "pad_boxes", "assign_anchor", "encode_labels",
           "encode_labels_batch", "decode_labels", "top_k_first",
           "xywh_grid_to_all", "xywh_all_to_grid"]

# Fixed gt-box capacity per image (VOC images have <= 56 objects).
MAX_BOXES = 64


def pad_boxes(boxes: np.ndarray, max_boxes: int = MAX_BOXES
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad an [n, 5] (class, x, y, w, h) annotation to [max_boxes, 5] and a
    [max_boxes] valid mask (host numpy)."""
    boxes = np.asarray(boxes, dtype=np.float32).reshape(-1, 5)
    n = min(len(boxes), max_boxes)
    out = np.zeros((max_boxes, 5), dtype=np.float32)
    out[:n] = boxes[:n]
    valid = np.zeros((max_boxes,), dtype=bool)
    valid[:n] = True
    return out, valid


@functools.lru_cache(maxsize=16)
def _anchors(spec: YoloSpec, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(spec.anchors_np()).to(device)


def assign_anchor(wh: torch.Tensor, anchors: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best (layer, anchor) per gt box: ``wh`` [..., 2], ``anchors``
    [L, A, 2] -> two int64 [...] tensors.  ``torch.argmax`` returns the
    first index on ties, as ``np.argmax`` does."""
    nl, na = anchors.shape[0], anchors.shape[1]
    iou = centered_iou(wh[..., None, None, :], anchors)            # [..., L, A]
    flat = torch.argmax(iou.reshape(*iou.shape[:-2], nl * na), dim=-1)
    return flat // na, flat % na


def encode_labels_batch(boxes: torch.Tensor, valid: torch.Tensor,
                        spec: YoloSpec) -> List[torch.Tensor]:
    """Encode boxes [B, M, 5] (class, x, y, w, h, normalised) with valid
    [B, M] into per-layer labels [B, h, w, anchor_num, 5 + class_num]
    float32."""
    bsz, m = boxes.shape[0], boxes.shape[1]
    device = boxes.device
    boxes = boxes.to(torch.float32)
    na, nc = spec.nanchors, spec.class_num
    layer_idx, anchor_idx = assign_anchor(boxes[..., 3:5],
                                          _anchors(spec, device))
    xywh = torch.clamp(boxes[..., 1:5], 1e-8, 1.0)
    payload = torch.cat([xywh, torch.ones_like(xywh[..., :1])], dim=-1)
    cls_idx = boxes[..., 0].to(torch.int64)         # truncates, as astype
    # a negative class wraps (numpy-style) before JAX's drop test
    cls_idx = torch.where(cls_idx < 0, cls_idx + nc, cls_idx)
    cls_ok = (cls_idx >= 0) & (cls_idx < nc)
    b_idx = torch.arange(bsz, device=device)[:, None].expand(bsz, m)
    upper = torch.triu(torch.ones((m, m), dtype=torch.bool, device=device),
                       diagonal=1)

    labels = []
    for l, (h, w) in enumerate(spec.out_hws):
        idx = torch.floor(boxes[..., 1] * w).to(torch.int64)
        idy = torch.floor(boxes[..., 2] * h).to(torch.int64)
        inb = (idx >= 0) & (idx < w) & (idy >= 0) & (idy < h)
        mine = valid & (layer_idx == l) & inb
        slot = (idy * w + idx) * na + anchor_idx                   # [B, M]
        # the last valid box of each slot writes the payload
        same = (slot[:, None, :] == slot[:, :, None]) \
            & mine[:, None, :] & mine[:, :, None]
        winner = mine & ~(same & upper).any(dim=-1)
        n_slots = h * w * na
        spare = torch.full_like(slot, n_slots)

        lab5 = torch.zeros((bsz, n_slots + 1, 5), device=device)
        lab5[b_idx, torch.where(winner, slot, spare)] = payload
        labc = torch.zeros((bsz, n_slots + 1, nc), device=device)
        writes = mine & cls_ok
        labc[b_idx, torch.where(writes, slot, spare),
             torch.where(writes, cls_idx, 0)] = 1.0
        labels.append(torch.cat([lab5[:, :n_slots], labc[:, :n_slots]], -1)
                      .reshape(bsz, h, w, na, 5 + nc))
    return labels


def encode_labels(boxes: torch.Tensor, valid: torch.Tensor,
                  spec: YoloSpec) -> List[torch.Tensor]:
    """One image: boxes [M, 5], valid [M] -> per-layer [h, w, a, 5 + C]."""
    return [lab[0] for lab in encode_labels_batch(boxes[None], valid[None],
                                                  spec)]


def top_k_first(values: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of the last dimension, ties in index order
    (``jax.lax.top_k``'s order; ``torch.topk`` leaves it open)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def decode_labels(labels: Sequence[torch.Tensor], spec: YoloSpec,
                  thresh: float = 0.7, max_boxes: int = MAX_BOXES
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`encode_labels` for one image: the ``max_boxes``
    rows of highest confidence as ([max_boxes, 5] (class, x, y, w, h),
    valid = conf > thresh)."""
    rows = torch.cat([lab.reshape(-1, spec.nchannels) for lab in labels], 0)
    top_conf, top_i = top_k_first(rows[:, 4], min(max_boxes, rows.shape[0]))
    rows = rows[top_i]
    cls = torch.argmax(rows[:, 5:], dim=-1).to(torch.float32)
    return torch.cat([cls[:, None], rows[:, :4]], dim=-1), top_conf > thresh


@functools.lru_cache(maxsize=64)
def _grid_consts_on(spec: YoloSpec, layer: int, device: torch.device,
                    dtype: torch.dtype):
    """(offset [h, w, 1, 2], anchors [a, 2], grid (w, h)), copied to the
    device once: a fresh host-to-device copy per call would wait for the
    device's queue."""
    h, w = spec.out_hws[layer]
    return (torch.from_numpy(spec.xy_offset(layer)).to(device),
            torch.from_numpy(spec.anchors_np()[layer]).to(device),
            torch.tensor([w, h], dtype=dtype, device=device))


def _grid_consts(layer: int, spec: YoloSpec, like: torch.Tensor):
    if torch.compiler.is_compiling():   # keep the tracer's tensors out
        return _grid_consts_on.__wrapped__(spec, layer, like.device,
                                           like.dtype)
    return _grid_consts_on(spec, layer, like.device, like.dtype)


def xywh_grid_to_all(grid_pred_xy: torch.Tensor, grid_pred_wh: torch.Tensor,
                     layer: int, spec: YoloSpec
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw head output [..., h, w, a, 2] each -> whole-image scale:
    ``(sigmoid(xy) + offset) / grid_wh`` and ``exp(wh) * anchors``."""
    offset, anchors, out_wh = _grid_consts(layer, spec, grid_pred_xy)
    return ((torch.sigmoid(grid_pred_xy) + offset) / out_wh,
            torch.exp(grid_pred_wh) * anchors)


def xywh_all_to_grid(all_true_xy: torch.Tensor, all_true_wh: torch.Tensor,
                     layer: int, spec: YoloSpec
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-image truth -> grid scale: ``xy * grid_wh - offset`` and
    ``log(wh / anchors)`` (-inf for empty cells; the loss masks it)."""
    offset, anchors, out_wh = _grid_consts(layer, spec, all_true_xy)
    return all_true_xy * out_wh - offset, torch.log(all_true_wh / anchors)

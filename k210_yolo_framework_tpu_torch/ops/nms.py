"""Per-class greedy NMS with fixed-size outputs, in plain torch.

Counterpart of ``k210_yolo_framework_tpu/ops/nms.py``: the export
program's NMS and the JAX tests' oracle for the NMS kernel.  Per class:

  1. the ``top_k`` highest-scoring candidates, in a stable descending order
     (ties keep the lower index first, as ``jax.lax.top_k`` does);
  2. a pairwise IoU matrix [K, K], upper-triangle masked so that a box can
     only suppress lower-ranked boxes;
  3. greedy selection as a fixed point over the whole batch:
     ``keep <- valid & ~(keep @ edge)`` until nothing changes, which is the
     sequential greedy answer after (longest suppression chain) sweeps
     (eagerly a Python loop; while ``torch.export`` traces, the same sweep
     as a ``while_loop``, as JAX's ``lax.while_loop``);
  4. kept boxes compacted into ``max_out`` slots in score order.

``finish_winners`` turns the winner buffers of the greedy-loop NMS (the
fused head and NMS alone, kernels and plain versions) into the same
``NmsResult`` layout.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from k210_yolo_framework_tpu_torch.ops.codec import top_k_first

__all__ = ["NmsResult", "batched_nms", "finish_winners", "greedy_keep_sorted",
           "greedy_keep_sorted_traced", "per_class_nms"]


class NmsResult(NamedTuple):
    """Fixed-size detections, class-major: entry ``c * max_out + k`` is the
    k-th kept box of class c.  Batched results carry a leading [B]."""

    boxes: torch.Tensor    # [B, C * max_out, 4] yxyx pixels
    scores: torch.Tensor   # [B, C * max_out]
    classes: torch.Tensor  # [B, C * max_out] int32
    valid: torch.Tensor    # [B, C * max_out] bool


def _iou_matrix_yxyx(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of [..., K, 4] yxyx boxes -> [..., K, K]."""
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    ymin = torch.maximum(boxes[..., :, None, 0], boxes[..., None, :, 0])
    xmin = torch.maximum(boxes[..., :, None, 1], boxes[..., None, :, 1])
    ymax = torch.minimum(boxes[..., :, None, 2], boxes[..., None, :, 2])
    xmax = torch.minimum(boxes[..., :, None, 3], boxes[..., None, :, 3])
    inter = torch.maximum(ymax - ymin, zero) * torch.maximum(xmax - xmin, zero)
    area = (torch.maximum(boxes[..., 2] - boxes[..., 0], zero)
            * torch.maximum(boxes[..., 3] - boxes[..., 1], zero))
    union = area[..., :, None] + area[..., None, :] - inter
    return torch.where(union > 0, inter / union, zero)


def _edges(boxes: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """[..., K, K] fp32: 1 where j < i and IoU(j, i) > iou_thresh."""
    k = boxes.shape[-2]
    tri = torch.triu(torch.ones((k, k), dtype=torch.bool,
                                device=boxes.device), 1)  # j suppresses i > j
    return ((_iou_matrix_yxyx(boxes) > iou_thresh) & tri).to(torch.float32)


def _sweep(keep: torch.Tensor, valid: torch.Tensor,
           edge: torch.Tensor) -> torch.Tensor:
    # suppressed[i] = any kept j < i that overlaps i; 0/1 sums are exact
    hits = torch.einsum("...j,...ji->...i", keep.to(torch.float32), edge)
    return valid & (hits == 0.0)


def greedy_keep_sorted(boxes: torch.Tensor, valid: torch.Tensor,
                       iou_thresh: float) -> torch.Tensor:
    """Exact greedy-NMS keep mask for score-descending candidates:
    boxes [..., K, 4], valid [..., K] -> keep [..., K] bool."""
    edge = _edges(boxes, iou_thresh)
    keep = valid
    while True:
        new = _sweep(keep, valid, edge)
        if torch.equal(new, keep):
            return keep
        keep = new


def greedy_keep_sorted_traced(boxes: torch.Tensor, valid: torch.Tensor,
                              iou_thresh: float) -> torch.Tensor:
    """:func:`greedy_keep_sorted` as a ``while_loop`` over (keep, changed),
    which ``torch.export`` captures (eagerly it compiles the loop first:
    seconds).  ``cond`` returns a copy: an output aliasing a carried input
    is refused."""
    from torch._higher_order_ops.while_loop import while_loop

    edge = _edges(boxes, iou_thresh)

    def cond(keep, changed):
        return changed.clone()

    def body(keep, changed):
        new = _sweep(keep, valid, edge)
        return new, torch.any(new != keep)

    keep, _ = while_loop(cond, body, (valid.clone(), torch.ones(
        (), dtype=torch.bool, device=valid.device)))
    return keep


def _compact(kept: torch.Tensor, boxes: torch.Tensor, scores: torch.Tensor,
             max_out: int):
    """Scatter kept entries (in score order) into ``max_out`` slots; one
    spare slot past the end takes the rest and is cut off."""
    rank = torch.cumsum(kept.to(torch.int64), dim=-1) - 1
    ok = kept & (rank < max_out)
    tgt = torch.where(ok, rank, torch.full_like(rank, max_out))
    lead = kept.shape[:-1]
    out_boxes = torch.zeros(lead + (max_out + 1, 4), dtype=boxes.dtype,
                            device=boxes.device)
    out_boxes.scatter_(-2, tgt[..., None].expand(boxes.shape), boxes)
    out_scores = torch.zeros(lead + (max_out + 1,), dtype=scores.dtype,
                             device=scores.device)
    out_scores.scatter_(-1, tgt, scores)
    out_valid = torch.zeros(lead + (max_out + 1,), dtype=torch.bool,
                            device=kept.device)
    out_valid.scatter_(-1, tgt, ok)
    return (out_boxes[..., :max_out, :], out_scores[..., :max_out],
            out_valid[..., :max_out])


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                score_thresh: float = 0.7, iou_thresh: float = 0.3,
                max_out: int = 30, top_k: int = 64) -> NmsResult:
    """boxes [B, N, 4] yxyx, scores [B, N, C] -> NmsResult [B, C * max_out].

    Exact for any input with at most ``top_k`` candidates per class above
    ``score_thresh``; the export program passes ``top_k = N``.  While
    ``torch.export`` traces, the greedy loop is
    :func:`greedy_keep_sorted_traced` (an eager ``while_loop`` compiles
    itself on every call)."""
    bsz, n, class_num = scores.shape
    k = min(top_k, n)
    top_scores, top_idx = top_k_first(scores.transpose(1, 2), k)  # [B, C, K]
    top_boxes = torch.gather(
        boxes[:, None].expand(bsz, class_num, n, 4), 2,
        top_idx[..., None].expand(bsz, class_num, k, 4))
    valid = top_scores >= score_thresh
    greedy = (greedy_keep_sorted_traced if torch.compiler.is_compiling()
              else greedy_keep_sorted)
    kept = greedy(top_boxes, valid, iou_thresh)
    b, s, v = _compact(kept, top_boxes, top_scores, max_out)
    classes = torch.arange(class_num, dtype=torch.int32, device=scores.device)
    classes = classes[None, :, None].expand(bsz, class_num, max_out)
    return NmsResult(boxes=b.reshape(bsz, -1, 4), scores=s.reshape(bsz, -1),
                     classes=classes.reshape(bsz, -1),
                     valid=v.reshape(bsz, -1))


def per_class_nms(boxes: torch.Tensor, scores: torch.Tensor,
                  score_thresh: float = 0.7, iou_thresh: float = 0.3,
                  max_out: int = 30, top_k: int = 64) -> NmsResult:
    """One image: boxes [N, 4] yxyx shared by the classes, scores [N, C] ->
    NmsResult [C * max_out]."""
    res = batched_nms(boxes[None], scores[None], score_thresh, iou_thresh,
                      max_out, top_k)
    return NmsResult(*(t[0] for t in res))


def finish_winners(out_scores: torch.Tensor, out_boxes: torch.Tensor,
                   score_thresh: float) -> NmsResult:
    """Winner buffers [B, C, M] and [B, C, M, 4] -> class-major NmsResult,
    slots below ``score_thresh`` zeroed and marked invalid."""
    bsz, classes, max_out = out_scores.shape
    valid = out_scores >= score_thresh
    boxes = torch.where(valid[..., None], out_boxes,
                        torch.zeros((), device=out_boxes.device))
    scores = torch.where(valid, out_scores,
                         torch.zeros((), device=out_scores.device))
    cls = torch.arange(classes, dtype=torch.int32, device=out_scores.device)
    cls = cls[None, :, None].expand(bsz, classes, max_out)
    return NmsResult(boxes=boxes.reshape(bsz, -1, 4),
                     scores=scores.reshape(bsz, -1),
                     classes=cls.reshape(bsz, -1),
                     valid=valid.reshape(bsz, -1))

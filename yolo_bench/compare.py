"""The comparisons that decide ``correct``.

Serving (:func:`detections`): the program's detections of a batch against
the reference's fp32 candidates and detections.  A detection's *cost*
against a candidate (or a detection) of its class is the larger of the
score gap and the box gap, the box gap being the largest coordinate gap
over the larger of the image's longer side and the candidate's box's
longer side (an exp-decoded box many times the image carries the relative
error of its logit).  One number, ``off_share``: the share of detections,
served and reference together, that are off:

* a served detection whose cost to every reference candidate of its class
  exceeds ``tau`` (its score or box is not the reference's), or that
  overlaps another served detection of its class by more than the NMS
  limit (greedy NMS keeps no such pair);
* a reference detection with no served detection of its class within
  ``tau``, unless the greedy selection may rightly have gone the other way:
  its score lies within ``tau`` of the threshold, a served detection of its
  class overlaps it by more than the NMS limit less ``IOU_SLACK`` (a near
  tie or a borderline overlap picked another winner), or its class's
  served list is full and its score is within ``tau`` of that list's last.

A share of a tail, not a widest gap: the program's bf16 and its own int8
path differ from the fp32 reference by rounding of one kind, about twice
apart in size, and only the tail beyond a tolerance sets them apart by
more (``PERF.md``).

Training (:func:`leaf_gaps`): per leaf, the gap between two norms over the
larger of the reference leaf's norm and the median leaf's; the cell takes
the worst leaf's for the parameters' change and the median leaf's for the
first gradient (``PERF.md``: the early depthwise layers' BatchNorm
gradients carry the whole backward pass's rounding, and even the
reference's own convs rounded to bf16 move them by up to 16%).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

Dets = Tuple[np.ndarray, np.ndarray, np.ndarray]   # boxes, scores, classes


def _cost(boxes: torch.Tensor, scores: torch.Tensor, to_boxes: torch.Tensor,
          to_scores: torch.Tensor, extent: float) -> torch.Tensor:
    """[k, m] cost of k detections against m candidates or detections of
    their classes (``to_scores`` [m], or [k, m]: each candidate's score for
    the detection's class); NaN costs infinity."""
    size = torch.maximum(to_boxes[:, 2] - to_boxes[:, 0],
                         to_boxes[:, 3] - to_boxes[:, 1])
    scale = torch.clamp_min(size, extent)                        # [m]
    box = (boxes[:, None, :] - to_boxes[None]).abs().amax(-1) / scale
    return torch.nan_to_num(torch.maximum(
        box, (scores[:, None] - to_scores).abs()), nan=float("inf"))


def _as_dets(d) -> Dets:
    return (np.asarray(d[0], np.float32).reshape(-1, 4),
            np.asarray(d[1], np.float32).reshape(-1),
            np.asarray(d[2]).reshape(-1).astype(np.int64))


IOU_SLACK = 0.05


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[k, m] IoU of y0, x0, y1, x1 boxes."""
    lo = torch.maximum(a[:, None, :2], b[None, :, :2])
    hi = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (hi - lo).clamp_min(0).prod(-1)
    area_a = (a[:, 2:] - a[:, :2]).clamp_min(0).prod(-1)
    area_b = (b[:, 2:] - b[:, :2]).clamp_min(0).prod(-1)
    union = area_a[:, None] + area_b[None] - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-30),
                       torch.zeros_like(inter))


def detections(served: Sequence, ref_boxes: torch.Tensor,
               ref_scores: torch.Tensor, ref_dets: Sequence[Dets],
               img_hws: torch.Tensor, tau: float, thresh: float,
               iou_thresh: float, max_out: int, chunk: int = 256) -> dict:
    """``served``: per image (boxes, scores, classes), the program's answer.
    ``ref_boxes`` [B, N, 4], ``ref_scores`` [B, N, C]: the reference's
    candidates; ``ref_dets``: its detections.  Returns the counts of this
    batch (module docstring)."""
    dev = ref_boxes.device
    off, n_served, n_ref = 0, 0, 0
    for i, (got, want) in enumerate(zip(served, ref_dets)):
        extent = float(img_hws[i].max())
        gb, gs, gc = (torch.from_numpy(a).to(dev) for a in _as_dets(got))
        wb, ws, wc = (torch.from_numpy(a).to(dev) for a in _as_dets(want))
        n_served += len(gs)
        n_ref += len(ws)
        for lo in range(0, len(gs), chunk):      # served: value
            sl = slice(lo, lo + chunk)
            cand = ref_scores[i][:, gc[sl]].T                      # [k, N]
            c = _cost(gb[sl], gs[sl], ref_boxes[i], cand, extent)
            off += int((c.amin(1) > tau).sum())
        if len(gs):                              # served: NMS kept no pair
            same = gc[:, None] == gc[None, :]
            pair = same & (_iou(gb, gb) > iou_thresh + IOU_SLACK)
            pair.fill_diagonal_(False)
            off += int(pair.any(1).sum())
        if not len(ws):
            continue
        if not len(gs):
            off += int((ws >= thresh + tau).sum())
            continue
        same = wc[:, None] == gc[None, :]                          # [r, k]
        near = same & (_cost(wb, ws, gb, gs, extent) <= tau)
        overlap = same & (_iou(wb, gb) > iou_thresh - IOU_SLACK)
        counts = torch.bincount(gc, minlength=int(wc.max()) + 1)
        lowest = torch.full_like(counts, float("inf"), dtype=gs.dtype)
        lowest.scatter_reduce_(0, gc, gs, "amin")
        full = (counts[wc] >= max_out) & (ws <= lowest[wc] + tau)
        excused = (ws < thresh + tau) | overlap.any(1) | full
        off += int((~near.any(1) & ~excused).sum())
    return {"off": off, "served": n_served, "reference": n_ref}


def merge(results: List[dict]) -> Dict[str, float]:
    """The batches' counts as the cell's share."""
    served = sum(r["served"] for r in results)
    ref = sum(r["reference"] for r in results)
    off = sum(r["off"] for r in results)
    return {"off_share": off / max(1, served + ref), "served": served,
            "reference": ref}


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              keep: Sequence[str]) -> Dict[str, float]:
    """Per leaf of ``keep``: |got - want| / max(want, the median leaf's
    want); inf where a norm is not finite."""
    med = float(np.median([want[k] for k in keep]))
    out = {}
    for k in keep:
        g = abs(got[k] - want[k]) / max(want[k], med)
        out[k] = g if np.isfinite(g) else float("inf")
    return out

"""Serving in plain fp32 PyTorch: the letterbox, the decode and per-class
greedy NMS, written from the K210 framework's description (``utils.py``:
``letterbox_image``, ``correct_box``; its per-class NMS), not from the
program.

* Letterbox: the image is scaled by s = min(in_w / w, in_h / h) with a
  triangle (bilinear, no antialias) filter whose output pixel o samples the
  input at (o - t) / s, t = trunc((in - size * s) / 2) on each axis, reads
  the whole canvas (zeros past the image), and is truncated to 0..255, as
  the framework stores it as uint8.
* Decode: xy = (sigmoid + cell) / grid, wh = exp * anchor; the letterbox
  undone with the framework's ``correct_box`` (the pad recomputed with
  round half to even); score = sigmoid(class) * sigmoid(objectness).
* NMS: for each image and class, repeatedly take the highest-scoring
  candidate (the first on a tie) while it reaches the threshold, keep it,
  and drop every candidate whose IoU with it exceeds ``iou_thresh``; at
  most ``max_out`` a class.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def _resample_matrix(n_in: int, n_out: int, scale: torch.Tensor,
                     shift: torch.Tensor) -> torch.Tensor:
    """[B, n_out, n_in] triangle-filter weights: output o samples the input
    at (o - shift) / scale."""
    o = torch.arange(n_out, dtype=torch.float32, device=scale.device)
    pos = (o[None, :] - shift[:, None]) / scale[:, None]           # [B, out]
    i = torch.arange(n_in, dtype=torch.float32, device=scale.device)
    w = torch.clamp_min(1.0 - torch.abs(pos[:, :, None] - i), 0.0)
    total = w.sum(-1, keepdim=True)
    w = torch.where(total > 1e-4, w / torch.where(total > 0, total, 1.0),
                    torch.zeros_like(w))
    inside = (pos >= -0.5) & (pos <= n_in - 0.5)
    return w * inside[:, :, None]


def letterbox_params(img_hws: torch.Tensor, in_hw) -> Tuple[torch.Tensor,
                                                            torch.Tensor]:
    """(scale [B], pad [B, 2] as (y, x))."""
    hw = img_hws.to(torch.float32)
    tgt = torch.tensor([float(in_hw[0]), float(in_hw[1])],
                       device=img_hws.device)
    scale = torch.min(tgt / hw, dim=-1).values
    pad = torch.trunc((tgt - hw * scale[:, None]) / 2.0)
    return scale, pad


def letterbox(canvases: torch.Tensor, img_hws: torch.Tensor, in_hw,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 canvases [B, H, W, 3] (image top-left) -> fp32 [B, in_h, in_w,
    3] holding whole numbers 0..255.  ``dtype`` is that of the resample's
    products (the rows, then the columns), which the configuration states:
    the stored image is what those products give."""
    scale, pad = letterbox_params(img_hws, in_hw)
    wy = _resample_matrix(canvases.shape[1], in_hw[0], scale, pad[:, 0])
    wx = _resample_matrix(canvases.shape[2], in_hw[1], scale, pad[:, 1])
    x = canvases.to(dtype)
    rows = torch.einsum("boh,bhwc->bowc", wy.to(dtype), x)
    out = torch.einsum("bpw,bowc->bopc", wx.to(dtype), rows)
    return torch.clamp(torch.trunc(out.to(torch.float32)), 0.0, 255.0)


def unit_scale(images: torch.Tensor) -> torch.Tensor:
    """Each image divided by its own max."""
    peak = images.flatten(1).amax(1).clamp_min(1e-12)
    return images / peak.view(-1, *([1] * (images.ndim - 1)))


def decode(logits: Sequence[torch.Tensor], anchors: np.ndarray, in_hw,
           img_hws: torch.Tensor):
    """Per layer [B, h, w, a, 5 + C] logits -> (boxes [B, N, 4] as y0, x0,
    y1, x1 pixels of each original image, scores [B, N, C]); candidates in
    layer, row, column, anchor order."""
    boxes, scores = [], []
    hw = img_hws.to(torch.float32)
    tgt = torch.tensor([float(in_hw[0]), float(in_hw[1])],
                       device=hw.device)
    new = torch.clamp_min(torch.round(hw * torch.min(tgt / hw, dim=-1,
                                                     keepdim=True).values),
                          1.0)
    off = ((tgt - new) / 2.0 / tgt)[:, None, :]                    # (y, x)
    mag = (tgt / new)[:, None, :]
    for layer, p in enumerate(logits):
        p = p.to(torch.float32)
        b, gh, gw, na, _ = p.shape
        gy, gx = torch.meshgrid(torch.arange(gh, device=p.device),
                                torch.arange(gw, device=p.device),
                                indexing="ij")
        anc = torch.as_tensor(anchors[layer], dtype=torch.float32,
                              device=p.device)                     # (w, h)
        cx = (torch.sigmoid(p[..., 0]) + gx[..., None]) / gw
        cy = (torch.sigmoid(p[..., 1]) + gy[..., None]) / gh
        w = torch.exp(p[..., 2]) * anc[:, 0]
        h = torch.exp(p[..., 3]) * anc[:, 1]
        yx = torch.stack([cy, cx], -1).reshape(b, -1, 2)
        size = torch.stack([h, w], -1).reshape(b, -1, 2)
        yx = (yx - off) * mag
        size = size * mag
        corners = torch.cat([yx - size / 2, yx + size / 2], -1)
        boxes.append(corners * torch.cat([hw, hw], -1)[:, None, :])
        scores.append((torch.sigmoid(p[..., 5:])
                       * torch.sigmoid(p[..., 4:5])).reshape(b, -1,
                                                             p.shape[-1] - 5))
    return torch.cat(boxes, 1), torch.cat(scores, 1)


def _iou_one(box: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """IoU of box [R, 4] with each of boxes [R, N, 4] (y0, x0, y1, x1)."""
    y0 = torch.maximum(box[:, None, 0], boxes[..., 0])
    x0 = torch.maximum(box[:, None, 1], boxes[..., 1])
    y1 = torch.minimum(box[:, None, 2], boxes[..., 2])
    x1 = torch.minimum(box[:, None, 3], boxes[..., 3])
    inter = torch.clamp_min(y1 - y0, 0) * torch.clamp_min(x1 - x0, 0)

    def area(b):
        return (torch.clamp_min(b[..., 2] - b[..., 0], 0)
                * torch.clamp_min(b[..., 3] - b[..., 1], 0))

    union = area(box)[:, None] + area(boxes) - inter
    return torch.where(union > 0, inter / torch.where(union > 0, union, 1.0),
                       torch.zeros_like(inter))


def nms(boxes: torch.Tensor, scores: torch.Tensor, thresh: float,
        iou_thresh: float, max_out: int):
    """boxes [B, N, 4], scores [B, N, C] -> (kept candidate index [B, C,
    max_out] (-1 where none), the live candidate tests the greedy steps
    needed: at each step of each (image, class) row still selecting, the
    candidates at or above ``thresh`` and not yet dropped)."""
    b, n, c = scores.shape
    s = scores.permute(0, 2, 1).reshape(b * c, n).clone()
    bx = boxes[:, None].expand(b, c, n, 4).reshape(b * c, n, 4)
    s = torch.where(s >= thresh, s, torch.full_like(s, -1.0))
    kept = torch.full((b * c, max_out), -1, dtype=torch.int64,
                      device=s.device)
    rows = torch.arange(b * c, device=s.device)
    live = torch.zeros((), dtype=torch.int64, device=s.device)
    for k in range(max_out):
        best, idx = torch.max(s, dim=1)
        active = best >= thresh
        live += torch.where(active[:, None], s >= thresh,
                            torch.zeros_like(active[:, None])).sum()
        if k % 8 == 0 and not bool(active.any()):
            break
        kept[:, k] = torch.where(active, idx, -1)
        drop = _iou_one(bx[rows, idx], bx) > iou_thresh
        drop[rows, idx] = True
        s = torch.where(drop & active[:, None], torch.full_like(s, -1.0), s)
    return kept.reshape(b, c, max_out), int(live)


def detections(boxes: torch.Tensor, scores: torch.Tensor,
               kept: torch.Tensor) -> List[Tuple[np.ndarray, np.ndarray,
                                                 np.ndarray]]:
    """Kept indices -> per image (boxes [k, 4], scores [k], classes [k]) as
    numpy, class by class in selection order."""
    out = []
    for i in range(kept.shape[0]):
        cls, slot = torch.nonzero(kept[i] >= 0, as_tuple=True)
        idx = kept[i, cls, slot]
        out.append((boxes[i, idx].cpu().numpy(),
                    scores[i, idx, cls].cpu().numpy(),
                    cls.cpu().numpy()))
    return out

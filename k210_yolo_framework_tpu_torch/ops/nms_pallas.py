"""Per-row greedy NMS selection in plain torch.

Counterpart of ``greedy_select_loop`` in
``k210_yolo_framework_tpu/ops/nms_pallas.py``, with the same semantics:

  * each leading-dims row of ``scores`` is one independent NMS problem (one
    (image, class) pair);
  * a step takes the row max (NaN propagates, so a row holding a NaN score
    never selects anything), picks the FIRST index holding it, reads that
    winner's box as ``max(coord, _NEG)`` (the masked-max pick of the TPU
    kernel), and suppresses every candidate with ``IoU > iou_thresh`` plus
    the winner itself;
  * the loop stops once no row's max reaches ``stop_below``.  Winners come
    out in non-increasing order and callers mask slots below the threshold,
    so stopping there never changes what a caller keeps.

The lane padding of the TPU version (``so`` slots rounded up to 128) has no
meaning here: the buffers are exactly ``max_out`` wide.  The CUDA kernel in
``csrc/yolo_head.cu`` runs the same steps, one thread block per row.
"""

from __future__ import annotations

import torch

__all__ = ["greedy_select_loop"]

_NEG = -1e9


def greedy_select_loop(scores: torch.Tensor, y0: torch.Tensor,
                       x0: torch.Tensor, y1: torch.Tensor, x1: torch.Tensor,
                       max_out: int, iou_thresh: float,
                       stop_below: float | None = None):
    """scores [..., N]; box coordinates broadcast against it.  Returns five
    ``[..., max_out]`` winner buffers ``(scores, y0, x0, y1, x1)``: winner k
    in slot k, unfilled slots hold ``_NEG`` score and zero coordinates."""
    scores = scores.clone()
    n = scores.shape[-1]
    lane = torch.arange(n, device=scores.device).expand(scores.shape)
    zero = torch.zeros((), dtype=scores.dtype, device=scores.device)
    neg = torch.full((), _NEG, dtype=scores.dtype, device=scores.device)
    big = torch.full((), 2 ** 30, dtype=lane.dtype, device=scores.device)
    area = (torch.maximum(y1 - y0, zero) * torch.maximum(x1 - x0, zero))
    stop = _NEG if stop_below is None else stop_below

    out_shape = scores.shape[:-1] + (max_out,)
    bufs = [torch.full(out_shape, _NEG, dtype=scores.dtype,
                       device=scores.device)]
    bufs += [torch.zeros(out_shape, dtype=scores.dtype, device=scores.device)
             for _ in range(4)]

    m = torch.amax(scores, dim=-1, keepdim=True)                  # [..., 1]
    for k in range(max_out):
        # any-row: a NaN row counts as done while healthy rows go on
        if not bool(torch.any(m >= stop)):
            break
        sel = torch.amin(torch.where(scores == m, lane, big), dim=-1,
                         keepdim=True)
        is_sel = lane == sel

        def pick(row):
            return torch.amax(torch.where(is_sel, row, neg), dim=-1,
                              keepdim=True)

        sy0, sx0, sy1, sx1 = pick(y0), pick(x0), pick(y1), pick(x1)
        s_area = (torch.maximum(sy1 - sy0, zero)
                  * torch.maximum(sx1 - sx0, zero))
        iy = torch.maximum(torch.minimum(sy1, y1) - torch.maximum(sy0, y0),
                           zero)
        ix = torch.maximum(torch.minimum(sx1, x1) - torch.maximum(sx0, x0),
                           zero)
        inter = iy * ix
        union = s_area + area - inter
        iou = torch.where(union > 0, inter / union, zero)
        scores = torch.where((iou > iou_thresh) | is_sel, neg, scores)
        for buf, v in zip(bufs, (m, sy0, sx0, sy1, sx1)):
            buf[..., k:k + 1] = v
        m = torch.amax(scores, dim=-1, keepdim=True)
    return tuple(bufs)

"""kmeans anchor generation with the 1 - IoU distance.

Counterpart of ``k210_yolo_framework_tpu/anchors/kmeans.py``:

  * every ground-truth box is letterbox-corrected to the net's scale first
    (the image pipeline's affine);
  * distance = 1 - IoU with both centres aligned (``ops/boxes.centered_iou``);
  * assignment by argmin, then the mean of each cluster; an emptied
    cluster gives NaN means, or with ``keep_empty`` keeps its centroid;
  * centroids sorted by descending w, so layer 0 gets the biggest anchors,
    reshaped to [layers, anchor_num, 2].

The loop is host-scale work (a few thousand (w, h) pairs, k of 6 or 9), so
:func:`kmeans_iou` runs on the CPU whatever device its inputs came from, as
the JAX package pins its loop to the CPU backend.  It is not a kernel path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from k210_yolo_framework_tpu_torch.ops.boxes import centered_iou

__all__ = ["letterbox_correct_boxes", "kmeans_iou", "generate_anchors"]


def letterbox_correct_boxes(ann_list: np.ndarray, in_hw: Tuple[int, int]
                            ) -> np.ndarray:
    """All ground-truth (w, h) pairs, letterbox-corrected to the net's
    scale: [n, 2] float64."""
    in_wh = np.array(in_hw[::-1], dtype=np.float64)
    whs = []
    for row in ann_list:
        boxes = np.array(row[1], dtype=np.float64, copy=True)
        img_wh = np.asarray(row[2], dtype=np.float64)[::-1]
        scale = np.min(in_wh / img_wh)
        whs.append(boxes[:, 3:5] * img_wh * scale / in_wh)
    return np.vstack(whs)


@torch.no_grad()
def kmeans_iou(x: torch.Tensor, init_centroids: torch.Tensor,
               iters: int = 10, keep_empty: bool = False,
               return_history: bool = False):
    """kmeans with d = 1 - centred IoU, on the CPU.  Returns (centroids,
    assignment), plus the centroids after each iteration [iters, k, 2]
    with ``return_history``.  An emptied cluster's centroid is NaN, or
    with ``keep_empty`` stays where it was."""
    x = torch.as_tensor(x).cpu()
    cents = torch.as_tensor(init_centroids).cpu()
    k = cents.shape[0]
    idx = torch.zeros((x.shape[0],), dtype=torch.int64)
    history = []
    for _ in range(iters):
        d = 1.0 - centered_iou(x[:, None, :], cents[None, :, :])   # [m, k]
        idx = torch.argmin(d, dim=1)
        onehot = torch.nn.functional.one_hot(idx, k).to(x.dtype)   # [m, k]
        sums = onehot.T @ x                                        # [k, 2]
        counts = onehot.sum(dim=0)[:, None]                        # [k, 1]
        if keep_empty:
            cents = torch.where(counts > 0,
                                sums / torch.clamp_min(counts, 1), cents)
        else:
            cents = sums / counts                                  # NaN if 0
        history.append(cents)
    if return_history:
        hist = torch.stack(history) if history else cents.new_zeros((0, k, 2))
        return cents, idx, hist
    return cents, idx


def generate_anchors(ann_list: np.ndarray, in_hw: Tuple[int, int],
                     layers: int, anchor_num: int, max_iters: int = 10,
                     is_random: bool = True, low=(0.0, 0.0), high=(1.0, 1.0),
                     seed: Optional[int] = None, retries: int = 10,
                     history_sink: Optional[list] = None) -> np.ndarray:
    """Anchors [layers, anchor_num, 2], normalised to the net's input.

    Random initial centroids come from ``np.random.default_rng(seed)``; a
    run whose cluster empties (NaN centroids) is retried up to ``retries``
    times with new draws, then run once more keeping emptied clusters.
    ``is_random=False`` starts from fixed linspace centroids.
    ``history_sink``, a list, receives (wh points [n, 2], centroid history
    [iters, k, 2]) of the run returned."""
    x = torch.from_numpy(letterbox_correct_boxes(ann_list, in_hw).astype(
        np.float32))
    k = layers * anchor_num
    rng = np.random.default_rng(seed)

    def make_init():
        if is_random:
            return np.hstack([
                rng.uniform(low[0], high[0], (k, 1)),
                rng.uniform(low[1], high[1], (k, 1)),
            ]).astype(np.float32)
        return np.vstack([np.linspace(0.05, 0.3, num=k),
                          np.linspace(0.05, 0.5, num=k)]).T.astype(np.float32)

    want_hist = history_sink is not None

    def fit(init, keep_empty=False):
        out = kmeans_iou(x, torch.from_numpy(init), iters=max_iters,
                         keep_empty=keep_empty, return_history=want_hist)
        return (out[0].numpy(),
                out[2].numpy() if want_hist else None)

    cents, history = None, None
    for _ in range(max(1, retries) if is_random else 1):
        cents, history = fit(make_init())
        if not np.any(np.isnan(cents)):
            break
    if np.any(np.isnan(cents)):
        cents, history = fit(make_init(), keep_empty=True)
    if want_hist:
        history_sink.append((x.numpy(), history))
    cents = np.array(sorted(cents, key=lambda c: -c[0]))
    return cents.reshape(layers, anchor_num, 2)

"""Detection-set matching for equivalence checks across implementations.

The port's copy of ``k210_yolo_framework_tpu/utils/detmatch.py`` (numpy
only), so that a check on the GPU machine imports nothing of the JAX
package's utilities.  ``tests/test_torch_predictor.py`` holds the two to the
same answers.

Two implementations that sum in different orders (cuDNN against XLA, bf16
against fp32, the card against the CPU) move scores at the ulp level, and a
score-tied or IoU-borderline greedy-NMS decision can then flip.  So the
detections are compared as SETS: greedy class + IoU matching with a tight
per-pair score bound, plus a cap on the number of unmatched detections.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["match_stats", "assert_detections_close"]


def _iou_matrix(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """IoU of every box of ``x`` [n, 4] with every box of ``y`` [m, 4], in
    their dtype, with the JAX package's per-pair arithmetic (areas not
    clamped, union floored at 1e-9)."""
    x, y = x[:, None, :], y[None, :, :]
    ymin, xmin = np.maximum(x[..., 0], y[..., 0]), np.maximum(x[..., 1],
                                                              y[..., 1])
    ymax, xmax = np.minimum(x[..., 2], y[..., 2]), np.minimum(x[..., 3],
                                                              y[..., 3])
    inter = np.maximum(ymax - ymin, 0.0) * np.maximum(xmax - xmin, 0.0)
    ax = (x[..., 2] - x[..., 0]) * (x[..., 3] - x[..., 1])
    ay = (y[..., 2] - y[..., 0]) * (y[..., 3] - y[..., 1])
    return inter / np.maximum(ax + ay - inter, 1e-9)


def match_stats(a, b, iou_min: float = 0.5,
                score_tol: Optional[float] = None
                ) -> Tuple[int, int, float]:
    """Greedy per-image detection matching ``a -> b``.

    A detection in ``a`` matches when ``b`` holds a detection of the same
    class with IoU >= ``iou_min`` (and, when ``score_tol`` is given,
    |score difference| <= score_tol).  Returns ``(unmatched, total,
    max_matched_score_diff)``, where a matched detection counts its
    smallest score difference.  Computed per image and class on whole
    matrices, with the answers of the JAX package's pair-by-pair loop.

    ``a``/``b`` are NmsResult-like: ``.boxes [B, N, 4]``, ``.scores``,
    ``.classes [B, N]``, ``.valid [B, N]`` (numpy arrays, or anything
    ``np.asarray`` takes).
    """
    va, vb = np.asarray(a.valid), np.asarray(b.valid)
    ba, bb = np.asarray(a.boxes), np.asarray(b.boxes)
    sa, sb = np.asarray(a.scores), np.asarray(b.scores)
    ca, cb = np.asarray(a.classes), np.asarray(b.classes)
    total = unmatched = 0
    max_ds = 0.0
    for i in range(va.shape[0]):
        cls_a, cls_b = ca[i, va[i]], cb[i, vb[i]]
        total += len(cls_a)
        for cls in np.unique(cls_a):
            ia, ib = cls_a == cls, cls_b == cls
            ds = np.abs(sa[i, va[i]][ia].astype(np.float64)[:, None]
                        - sb[i, vb[i]][ib].astype(np.float64)[None, :])
            ok = _iou_matrix(ba[i, va[i]][ia], bb[i, vb[i]][ib]) >= iou_min
            if score_tol is not None:
                ok &= ds <= score_tol
            found = ok.any(axis=1)
            unmatched += int((~found).sum())
            if found.any():
                best = np.where(ok, ds, np.inf).min(axis=1)
                max_ds = max(max_ds, float(best[found].max()))
    return unmatched, total, max_ds


def assert_detections_close(a, b, iou_min: float = 0.5,
                            max_flip_frac: float = 0.005,
                            score_tol: float = 1e-3,
                            min_flips_allowed: int = 1) -> Tuple[int, int]:
    """Assert two detection sets agree: at most ``max(min_flips_allowed,
    ceil(max_flip_frac * total))`` unmatched detections in EITHER direction,
    and every matched pair's scores within ``score_tol``.  Returns
    ``(total_a, total_b)`` for reporting."""
    un_ab, n_a, ds_ab = match_stats(a, b, iou_min)
    un_ba, n_b, ds_ba = match_stats(b, a, iou_min)
    allowed_a = max(min_flips_allowed, int(np.ceil(max_flip_frac * n_a)))
    allowed_b = max(min_flips_allowed, int(np.ceil(max_flip_frac * n_b)))
    assert un_ab <= allowed_a, (
        f"{un_ab}/{n_a} detections flipped a->b (allowed {allowed_a})")
    assert un_ba <= allowed_b, (
        f"{un_ba}/{n_b} detections flipped b->a (allowed {allowed_b})")
    assert ds_ab <= score_tol and ds_ba <= score_tol, (
        f"matched-set score disagreement: {max(ds_ab, ds_ba):.2e} "
        f"> {score_tol:.0e}")
    return n_a, n_b

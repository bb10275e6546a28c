"""VOC-style mAP evaluation.

Counterpart of ``k210_yolo_framework_tpu/eval.py`` (numpy and the host
loader only): batched inference through a ``Predictor`` over an
annotation list (rows ``[image_path, boxes[n, 5], (h, w)]``), and the VOC AP
computation, 11-point interpolated (VOC2007) or all-points (VOC2010+);
and the calibration rows of the ``int8_act_cal`` mode
(``split_calibration_rows``, ``calibrate_from_rows``).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from k210_yolo_framework_tpu_torch.data.annotations import read_image
from k210_yolo_framework_tpu_torch.data.pipeline import stage_image

__all__ = ["voc_ap", "DetectionRecord", "match_detections",
           "match_detections_sweep", "collect_detections", "evaluate_map",
           "split_calibration_rows", "calibrate_from_rows"]


def voc_ap(recall: np.ndarray, precision: np.ndarray,
           use_07_metric: bool = True) -> float:
    """AP from (recall, precision) curves, VOC semantics."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(precision[recall >= t]) if np.any(recall >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


class DetectionRecord:
    """Detections and ground truth accumulated over a dataset."""

    def __init__(self, class_num: int):
        self.class_num = class_num
        self.dets: List[List[Tuple[int, float, np.ndarray]]] = [
            [] for _ in range(class_num)]  # (image_id, score, yxyx)
        self.gts: List[Dict[int, np.ndarray]] = [
            {} for _ in range(class_num)]  # image_id -> [n, 4] yxyx

    def add_image(self, image_id: int, det_boxes: np.ndarray,
                  det_scores: np.ndarray, det_classes: np.ndarray,
                  gt_boxes: np.ndarray, gt_classes: np.ndarray):
        for b, s, c in zip(det_boxes, det_scores, det_classes):
            self.dets[int(c)].append((image_id, float(s),
                                      np.asarray(b, float)))
        for c in range(self.class_num):
            m = gt_classes == c
            if m.any():
                self.gts[c][image_id] = np.asarray(gt_boxes[m], float)


def _iou_1toN(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    ymin = np.maximum(box[0], boxes[:, 0])
    xmin = np.maximum(box[1], boxes[:, 1])
    ymax = np.minimum(box[2], boxes[:, 2])
    xmax = np.minimum(box[3], boxes[:, 3])
    inter = np.maximum(ymax - ymin, 0) * np.maximum(xmax - xmin, 0)
    a1 = max(box[2] - box[0], 0) * max(box[3] - box[1], 0)
    a2 = (np.maximum(boxes[:, 2] - boxes[:, 0], 0)
          * np.maximum(boxes[:, 3] - boxes[:, 1], 0))
    union = a1 + a2 - inter
    return np.where(union > 0, inter / union, 0.0)


def match_detections(record: DetectionRecord, map_iou: float = 0.5,
                     use_07_metric: bool = True) -> Dict[str, object]:
    """Greedy per-class matching (the VOC protocol) -> AP per class; a
    class absent from the ground truth is skipped (NaN)."""
    aps = np.full((record.class_num,), np.nan)
    for c in range(record.class_num):
        gts = record.gts[c]
        npos = sum(len(v) for v in gts.values())
        dets = sorted(record.dets[c], key=lambda d: -d[1])
        if npos == 0:
            continue
        matched = {k: np.zeros(len(v), bool) for k, v in gts.items()}
        tp = np.zeros(len(dets))
        fp = np.zeros(len(dets))
        for i, (img, _score, box) in enumerate(dets):
            g = gts.get(img)
            if g is None or len(g) == 0:
                fp[i] = 1
                continue
            ious = _iou_1toN(box, g)
            j = int(np.argmax(ious))
            if ious[j] >= map_iou and not matched[img][j]:
                tp[i] = 1
                matched[img][j] = True
            else:
                fp[i] = 1
        ctp, cfp = np.cumsum(tp), np.cumsum(fp)
        recall = ctp / npos
        precision = ctp / np.maximum(ctp + cfp, 1e-12)
        aps[c] = voc_ap(recall, precision, use_07_metric)
    return {"ap": aps,
            "map": float(np.nanmean(aps)) if np.any(~np.isnan(aps)) else 0.0}


def match_detections_sweep(record: DetectionRecord,
                           ious: Sequence[float] = tuple(
                               np.arange(0.5, 1.0, 0.05)),
                           use_07_metric: bool = False) -> Dict[str, object]:
    """COCO-style mAP@[.5:.95]: the mean of the VOC matcher over an IoU
    sweep (detections collected once, matched per threshold)."""
    maps = [match_detections(record, float(t), use_07_metric)["map"]
            for t in ious]
    return {"map_per_iou": dict(zip([round(float(t), 2) for t in ious], maps)),
            "map": float(np.mean(maps))}


def evaluate_map(predictor, ann_list: np.ndarray, class_num: int,
                 map_iou: float = 0.5, use_07_metric: bool = True,
                 batch_size: int = 32, canvas_hw: Tuple[int, int] = (512, 512),
                 progress=None) -> Dict[str, object]:
    """Run ``predictor`` (``inference.Predictor``) over the dataset and
    score mAP.  For mAP the predictor wants a low ``obj_thresh`` (0.01) and
    a larger ``max_out`` (100): AP integrates the whole precision/recall
    curve."""
    record = collect_detections(predictor, ann_list, class_num, batch_size,
                                canvas_hw, progress)
    return match_detections(record, map_iou, use_07_metric)


def collect_detections(predictor, ann_list: np.ndarray, class_num: int,
                       batch_size: int = 32,
                       canvas_hw: Tuple[int, int] = (512, 512),
                       progress=None) -> DetectionRecord:
    """Batched inference over the dataset -> DetectionRecord (score once,
    match at any IoU).

    Host decode and staging run on a thread pool one batch ahead of the
    device.  The last batch is padded to ``batch_size`` with copies of its
    last image, whose detections are dropped.  Ground truth is put in the
    pixels of the staged image, the frame the detections come back in."""
    record = DetectionRecord(class_num)
    n = len(ann_list)
    pool = ThreadPoolExecutor(min(8, max(2, os.cpu_count() or 1)))

    def stage(row):
        return stage_image(read_image(str(row[0])), canvas_hw)

    def submit(start):
        rows = [ann_list[i] for i in range(start, min(start + batch_size, n))]
        return rows, [pool.submit(stage, r) for r in rows]

    try:
        pending = submit(0)
        for start in range(0, n, batch_size):
            rows, futs = pending
            if start + batch_size < n:
                pending = submit(start + batch_size)
            canvases, hws = zip(*(f.result() for f in futs))
            canvases, hws = np.stack(canvases), np.stack(hws)
            if len(rows) < batch_size:
                pad = batch_size - len(rows)
                canvases = np.concatenate(
                    [canvases, np.repeat(canvases[-1:], pad, 0)])
                hws = np.concatenate([hws, np.repeat(hws[-1:], pad, 0)])
            dets = predictor.predict_batch(canvases, hws)
            for k, (row, det) in enumerate(zip(rows, dets)):
                h, w = hws[k]
                gt = np.asarray(row[1], float)
                # normalised (cls, cx, cy, w, h) -> pixel yxyx, staged size
                cy, cx = gt[:, 2] * h, gt[:, 1] * w
                bh, bw = gt[:, 4] * h, gt[:, 3] * w
                gt_boxes = np.stack([cy - bh / 2, cx - bw / 2,
                                     cy + bh / 2, cx + bw / 2], axis=1)
                record.add_image(start + k, det.boxes, det.scores,
                                 det.classes, gt_boxes, gt[:, 0].astype(int))
            if progress is not None:
                progress(min(start + batch_size, n), n)
        return record
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


def split_calibration_rows(ann_list: np.ndarray,
                           calib_list: Optional[np.ndarray] = None,
                           calib_size: int = 32
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Pick activation-calibration rows disjoint from the eval rows ->
    (eval rows, calibration rows).

    With an explicit ``calib_list`` (e.g. the train split) eval keeps the
    whole ``ann_list`` and calibration takes the first ``calib_size`` rows
    of ``calib_list``.  Without one, the last ``calib_size`` rows of
    ``ann_list`` are held out of eval for calibration.  Raises when
    ``calib_size`` is not positive, when ``calib_list`` is shorter than
    ``calib_size``, when a calibration row's image is also an eval image,
    and when ``ann_list`` is too short to hold rows out."""
    if calib_size <= 0:
        raise ValueError(f"calib_size must be positive, got {calib_size}")
    if calib_list is not None:
        if len(calib_list) < calib_size:
            raise ValueError(
                f"calibration list holds {len(calib_list)} rows but "
                f"calib_size={calib_size}; pass a longer list or lower "
                "calib_size (silently calibrating on fewer rows than "
                "requested hides a data problem)")
        drawn = calib_list[:calib_size]
        eval_paths = {str(r[0]) for r in ann_list}
        shared = [str(r[0]) for r in drawn if str(r[0]) in eval_paths]
        if shared:
            raise ValueError(
                f"{len(shared)} calibration row(s) also appear in the eval "
                f"list (e.g. {shared[0]}) — calibrating on eval images "
                "leaks evaluation data into the quantization ranges; use a "
                "disjoint list (the train split)")
        return ann_list, drawn
    if len(ann_list) <= calib_size:
        raise ValueError(
            f"cannot hold out {calib_size} calibration rows from a "
            f"{len(ann_list)}-row eval list; pass a separate calibration "
            "list (e.g. the train split) or lower calib_size")
    return ann_list[:-calib_size], ann_list[-calib_size:]


def calibrate_from_rows(predictor, rows: np.ndarray,
                        canvas_hw: Tuple[int, int] = (512, 512)) -> None:
    """Stage ``rows`` (ann-list format) as serving does and record the
    activation ranges of an ``int8_act_cal`` predictor from them (one
    unquantized forward over the representative set)."""
    staged = [stage_image(read_image(str(r[0])), canvas_hw) for r in rows]
    canvases, hws = zip(*staged)
    predictor.calibrate(np.stack(canvases), np.stack(hws))

"""The port's VOC mAP harness against the JAX package's.

The AP math and the matchers exactly, on seeded random records;
``collect_detections`` through the port's ``Predictor`` against the JAX
package's through the JAX ``Predictor``, on the small bridged net and a few
synthetic JPEGs, at the eval settings (obj_thresh 0.01, iou_thresh 0.45,
max_out 100, 512x512 canvases, a padded tail batch): the ground truth
exactly, the detections as sets (``utils/detmatch``, fp32 tolerances); and
the guards of ``split_calibration_rows``.
"""

import numpy as np
import pytest
import torch

from k210_yolo_framework_tpu import eval as JE
from k210_yolo_framework_tpu.config import VOC_ANCHORS, YoloSpec
from k210_yolo_framework_tpu.inference import Predictor as JaxPredictor
from k210_yolo_framework_tpu_torch import config as TC
from k210_yolo_framework_tpu_torch import eval as TE
from k210_yolo_framework_tpu_torch.data.pipeline import synthetic_ann_list
from k210_yolo_framework_tpu_torch.inference import (
    Detections,
    Predictor,
    stack_detections,
)
from k210_yolo_framework_tpu_torch.training import checkpoint as TCK
from k210_yolo_framework_tpu_torch.utils.detmatch import (
    assert_detections_close,
)

from test_torch_model import SMALL, jax_net_and_flat, torch_net

torch.set_num_threads(1)

EVAL = dict(obj_thresh=0.01, iou_thresh=0.45, max_out=100)


def _records(seed, class_num=4, images=12):
    """The same random detections and ground truth in a record of each
    package: boxes near the ground truth, some far off, tied scores."""
    rng = np.random.default_rng(seed)
    recs = (JE.DetectionRecord(class_num), TE.DetectionRecord(class_num))
    for img in range(images):
        ng = int(rng.integers(0, 5))
        yx = rng.uniform(0, 200, (ng, 2))
        gt = np.concatenate([yx, yx + rng.uniform(10, 60, (ng, 2))], 1)
        gcls = rng.integers(0, class_num - 1, ng)     # last class: no gt
        nd = int(rng.integers(0, 8))
        pick = rng.integers(0, max(ng, 1), nd)
        near = gt[pick] if ng else rng.uniform(0, 200, (nd, 4))
        det = near + rng.normal(0, 6, (nd, 4))
        far = rng.uniform(0, 1, nd) < 0.3
        det[far] += 150.0
        scores = np.round(rng.uniform(0, 1, nd), 1)   # ties
        dcls = np.where(rng.uniform(0, 1, nd) < 0.8,
                        gcls[pick] if ng else 0,
                        rng.integers(0, class_num, nd))
        for r in recs:
            r.add_image(img, det, scores, dcls, gt, gcls)
    return recs


def test_voc_ap_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        n = int(rng.integers(1, 30))
        recall = np.sort(rng.uniform(0, 1, n))
        precision = rng.uniform(0, 1, n)
        for use_07 in (True, False):
            assert TE.voc_ap(recall, precision, use_07) == JE.voc_ap(
                recall, precision, use_07)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matchers_match_jax_exactly(seed):
    jrec, trec = _records(seed)
    for map_iou in (0.3, 0.5, 0.75):
        for use_07 in (True, False):
            want = JE.match_detections(jrec, map_iou, use_07)
            got = TE.match_detections(trec, map_iou, use_07)
            np.testing.assert_array_equal(got["ap"], want["ap"])
            assert got["map"] == want["map"]
    want, got = JE.match_detections_sweep(jrec), TE.match_detections_sweep(trec)
    assert got == want
    assert 0.0 < got["map"] < 1.0


def _as_result(record, n_images):
    """A DetectionRecord's detections per image, stacked into the padded
    layout detmatch reads."""
    per = [[] for _ in range(n_images)]
    for c, dets in enumerate(record.dets):
        for img, score, box in dets:
            per[img].append((box, score, c))
    return stack_detections([Detections(
        np.reshape([d[0] for d in p], (-1, 4)), np.array([d[1] for d in p]),
        np.array([d[2] for d in p], int)) for p in per])


def test_collect_detections_matches_jax(tmp_path):
    n_img = 6
    ann = synthetic_ann_list(str(tmp_path), n=n_img,
                             class_num=SMALL["class_num"], seed=4)
    jnet, variables, flat = jax_net_and_flat()
    jspec = YoloSpec.create(SMALL["in_hw"], ((2, 3), (4, 6)),
                            SMALL["class_num"], np.asarray(VOC_ANCHORS))
    tspec = TC.YoloSpec.create(SMALL["in_hw"], ((2, 3), (4, 6)),
                               SMALL["class_num"], np.asarray(VOC_ANCHORS))
    jp = JaxPredictor(jnet, variables, jspec, **EVAL)
    tp = Predictor(torch_net(), TCK.state_dict_from_flat(flat), tspec,
                   device="cpu", **EVAL)
    seen = []
    want = JE.collect_detections(jp, ann, SMALL["class_num"], batch_size=4)
    got = TE.collect_detections(tp, ann, SMALL["class_num"], batch_size=4,
                                progress=lambda d, t: seen.append((d, t)))
    assert seen == [(4, n_img), (6, n_img)]
    for c in range(SMALL["class_num"]):
        assert sorted(got.gts[c]) == sorted(want.gts[c])
        for img, boxes in want.gts[c].items():
            np.testing.assert_array_equal(got.gts[c][img], boxes)
    n_a, n_b = assert_detections_close(_as_result(got, n_img),
                                       _as_result(want, n_img))
    assert n_a > n_img * 30           # obj_thresh 0.01 keeps many boxes
    assert max(len(d) for d in got.dets) > 0
    m_got = TE.match_detections(got)["map"]
    m_want = JE.match_detections(want)["map"]
    assert np.isfinite(m_got) and abs(m_got - m_want) <= 0.02


def _rows(prefix, n):
    return np.array([[f"{prefix}{i}.jpg", None, None] for i in range(n)],
                    dtype=object)


def test_split_calibration_rows_holdout_and_explicit_list():
    ann = _rows("e", 10)
    ev, cal = TE.split_calibration_rows(ann, calib_size=3)
    assert [r[0] for r in cal] == ["e7.jpg", "e8.jpg", "e9.jpg"]
    assert len(ev) == 7 and {r[0] for r in ev}.isdisjoint(
        {r[0] for r in cal})
    ev, cal = TE.split_calibration_rows(ann, _rows("c", 50), calib_size=8)
    assert len(ev) == 10 and [r[0] for r in cal] == [f"c{i}.jpg"
                                                      for i in range(8)]


@pytest.mark.parametrize("guard", ["short_list", "overlap", "tiny_eval",
                                   "size"])
def test_split_calibration_rows_guards(guard):
    ann = _rows("e", 10)
    if guard == "short_list":
        args, match = (ann, _rows("c", 5), 8), "calib_size"
    elif guard == "overlap":
        args, match = (ann, np.concatenate([_rows("c", 3), ann[3:4]]),
                       4), "leak"
    elif guard == "tiny_eval":
        args, match = (ann[:3], None, 8), "hold out"
    else:
        args, match = (ann, None, 0), "positive"
    with pytest.raises(ValueError, match=match):
        TE.split_calibration_rows(*args)
    with pytest.raises(ValueError, match=match):
        JE.split_calibration_rows(*args)

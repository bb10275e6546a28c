"""Port decode+NMS head (torch) against the JAX head.

On the CPU ``fused_decode_nms`` of both packages runs its plain version
(the JAX one its jnp twin, the port its torch reference).  Tolerances are
those of ``tests/test_yolo_head_pallas.py``: valid exact, scores rtol 2e-5 /
atol 1e-6, boxes rtol 1e-3 / atol 0.05.  The CUDA kernel itself is checked
against the plain version by ``tests/test_torch_cuda.py`` (which needs a
GPU) and by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from k210_yolo_framework_tpu import config as JConfig
from k210_yolo_framework_tpu.ops import nms_pallas as JN
from k210_yolo_framework_tpu.ops import yolo_head_pallas as JH
from k210_yolo_framework_tpu_torch import config as TConfig
from k210_yolo_framework_tpu_torch.ops import nms_pallas as TN
from k210_yolo_framework_tpu_torch.ops import yolo_head_pallas as TH

torch.set_num_threads(1)


def _specs(name="c6", classes=6):
    """(JAX spec, port spec) from the same arguments: the JAX one goes to
    JAX functions, the port's to the port's."""
    if name == "voc":
        return JConfig.voc_spec(), TConfig.voc_spec()
    rng = np.random.default_rng(2)
    anchors = np.sort(rng.uniform(0.05, 0.9, (2, 3, 2)).astype(np.float32))[:, ::-1]
    args = ((224, 320), ((7, 10), (14, 20)), classes, anchors)
    return JConfig.YoloSpec.create(*args), TConfig.YoloSpec.create(*args)


def _preds(spec, bsz, seed, std=2.0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, std, (bsz, h, w, spec.nanchors, 5 + spec.class_num))
            .astype(np.float32) for h, w in spec.out_hws]


def _assert_results_close(got, want):
    np.testing.assert_array_equal(np.asarray(got.valid), np.asarray(want.valid))
    np.testing.assert_array_equal(np.asarray(got.classes),
                                  np.asarray(want.classes))
    np.testing.assert_allclose(np.asarray(got.scores), np.asarray(want.scores),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.boxes), np.asarray(want.boxes),
                               rtol=1e-3, atol=0.05)


@pytest.mark.parametrize("spec_name", ["c6", "voc"])
def test_candidate_geometry_exact(spec_name):
    jspec, tspec = _specs(spec_name)
    np.testing.assert_array_equal(TH.candidate_geometry(tspec),
                                  JH.candidate_geometry(jspec))


def test_letterbox_inverse_params_exact():
    hws = np.array([[375, 500], [224, 320], [4000, 8], [101, 333], [1, 1]],
                   np.int32)
    got = TH.letterbox_inverse_params(torch.from_numpy(hws), (224, 320))
    want = JH.letterbox_inverse_params(jnp.asarray(hws), (224, 320))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _select_case(case, seed=17, n=64, c=4):
    """Boxes and scores of tests/test_nms_pallas.py's early-exit cases."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 120, (n, 2))
    lo, hi = (40, 80) if case == "dense" else (10, 60)
    wh = rng.uniform(lo, hi, (n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.uniform(0, 0.5 if case == "empty" else 1.0,
                         (c, n)).astype(np.float32)
    if case == "nan":
        scores[1, 5] = np.nan      # one poisoned row among healthy ones
    if case == "ties":
        scores[:, ::3] = 0.875     # exact ties: the first index wins
    return boxes, scores


@pytest.mark.parametrize("stop_below,case", [
    (0.7, "sparse"), (0.7, "empty"), (0.01, "dense"), (0.3, "nan"),
    (0.3, "ties"),
])
def test_greedy_select_loop_matches_jax(stop_below, case):
    boxes, scores = _select_case(case)
    j_args = (jnp.asarray(scores),
              *(jnp.asarray(boxes[:, i])[None, :] for i in range(4)))
    want = JN.greedy_select_loop(*j_args, 128, 30, 0.3, stop_below=stop_below)
    t_args = (torch.from_numpy(scores),
              *(torch.from_numpy(boxes[:, i])[None, :] for i in range(4)))
    got = TN.greedy_select_loop(*t_args, 30, 0.3, stop_below=stop_below)
    keep = np.asarray(want[0])[:, :30] >= stop_below
    np.testing.assert_array_equal(got[0].numpy() >= stop_below, keep)
    assert keep.any() == (case != "empty")
    if case == "nan":
        assert not keep[1].any() and keep[[0, 2, 3]].any()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.where(keep, g.numpy(), 0),
                                      np.where(keep, np.asarray(w)[:, :30], 0))


@pytest.mark.parametrize("class_softmax", [False, True])
@pytest.mark.parametrize("spec_name,bsz", [("c6", 3), ("voc", 2)])
def test_fused_decode_nms_matches_jax(spec_name, bsz, class_softmax):
    jspec, tspec = _specs(spec_name)
    preds = _preds(tspec, bsz, seed=0)
    rng = np.random.default_rng(1)
    img_hws = rng.integers(100, 512, (bsz, 2)).astype(np.int32)
    thresh = 0.05 if class_softmax else 0.3
    want = JH.fused_decode_nms([jnp.asarray(p) for p in preds], jspec,
                               jnp.asarray(img_hws), thresh, 0.45, 30,
                               class_softmax=class_softmax)
    got = TH.fused_decode_nms([torch.from_numpy(p) for p in preds], tspec,
                              torch.from_numpy(img_hws), thresh, 0.45, 30,
                              class_softmax=class_softmax)
    assert np.asarray(want.valid).any()
    _assert_results_close(got, want)


@pytest.mark.parametrize("case", ["empty", "dense", "nan_row"])
def test_fused_decode_nms_edge_cases_match_jax(case):
    jspec, tspec = _specs(classes=3)
    preds = _preds(tspec, 2, seed=4)
    if case == "empty":
        preds = [np.full_like(p, -10.0) for p in preds]
    elif case == "dense":      # every candidate of every class clears 0.7
        for p in preds:
            p[..., 4:] += 6.0
    else:                      # one NaN logit poisons class 1 of image 0
        preds[0][0, 1, 2, 0, 5 + 1] = np.nan
    img_hws = np.array([[300, 400], [224, 320]], np.int32)
    want = JH.fused_decode_nms([jnp.asarray(p) for p in preds], jspec,
                               jnp.asarray(img_hws), 0.7, 0.3, 30)
    got = TH.fused_decode_nms([torch.from_numpy(p) for p in preds], tspec,
                              torch.from_numpy(img_hws), 0.7, 0.3, 30)
    _assert_results_close(got, want)
    valid = got.valid.numpy().reshape(2, 3, 30)
    if case == "empty":
        assert not valid.any()
    elif case == "dense":
        assert valid.all()
    else:
        assert not valid[0, 1].any() and valid[1, 1].any()


@pytest.mark.parametrize("thresh", [0.7, 0.25, 0.01])
@pytest.mark.parametrize("case", ["dense", "ties"])
def test_dropping_scores_below_the_threshold_keeps_the_head(case, thresh,
                                                           monkeypatch):
    """The rule the kernel's live list rests on, for the fused head: the
    plain version with every score below the threshold set to -inf before
    its loop against JAX's head on the same logits, unchanged."""
    jspec, tspec = _specs(classes=3)
    preds = _preds(tspec, 2, seed=5)
    for p in preds:
        if case == "dense":
            p[..., 4:] += 3.0
        else:
            p[..., 4:] = 2.0       # every score equal: the first index wins
    img_hws = np.array([[300, 400], [224, 320]], np.int32)
    select = TH.greedy_select_loop
    dropped = []

    def drop_then_select(scores, *args, stop_below, **kw):
        dropped.append(int((scores < stop_below).sum()))
        scores = torch.where(scores < stop_below, -torch.inf, scores)
        return select(scores, *args, stop_below=stop_below, **kw)

    monkeypatch.setattr(TH, "greedy_select_loop", drop_then_select)
    got = TH.fused_decode_nms_reference(
        [torch.from_numpy(p) for p in preds], tspec,
        torch.from_numpy(img_hws), thresh, 0.3, 30)
    want = JH.fused_decode_nms([jnp.asarray(p) for p in preds], jspec,
                               jnp.asarray(img_hws), thresh, 0.3, 30)
    assert (dropped[0] > 0) == (case == "dense")
    assert got.valid.numpy().any()
    _assert_results_close(got, want)


def test_fused_decode_nms_rejects_other_devices():
    preds = [torch.zeros((1, 7, 10, 3, 25), device="meta"),
             torch.zeros((1, 14, 20, 3, 25), device="meta")]
    with pytest.raises(ValueError, match="no kernel"):
        TH.fused_decode_nms(preds, TConfig.voc_spec(),
                            torch.tensor([[224, 320]]))


def test_cpu_path_does_not_launch():
    before = TH.fused_decode_nms.launches
    _, spec = _specs(classes=3)
    TH.fused_decode_nms([torch.from_numpy(p) for p in _preds(spec, 1, 3)],
                        spec, torch.tensor([[224, 320]]))
    assert TH.fused_decode_nms.launches == before

"""The port's two-stage head against the JAX package's: decode, the XLA
NMS of ``ops/nms.py`` and NMS alone (``batched_nms_pallas``).

On the CPU the port's ``batched_nms_pallas`` runs its plain version, held
exactly to JAX's ``batched_nms_pallas(interpret=True)`` (its jnp twin of the
kernel) on the cases of ``tests/test_nms_pallas.py``; the CUDA kernel is
held to the plain version bit for bit by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.  Decode: rtol 1e-6 (see ``test_decode_outputs_matches_jax``
for the boxes' atol).  The two-stage path against the port's fused head:
the tolerances of ``tests/test_yolo_head_pallas.py``.
"""

import functools
import math
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from k210_yolo_framework_tpu import config as JC
from k210_yolo_framework_tpu.ops import decode as JD
from k210_yolo_framework_tpu.ops import nms as JN
from k210_yolo_framework_tpu.ops import nms_pallas as JNP
from k210_yolo_framework_tpu_torch import config as TC
from k210_yolo_framework_tpu_torch.ops import _build
from k210_yolo_framework_tpu_torch.ops import decode as TD
from k210_yolo_framework_tpu_torch.ops import nms as TN
from k210_yolo_framework_tpu_torch.ops import nms_pallas as TNP
from k210_yolo_framework_tpu_torch.ops import yolo_head_pallas as TH

from test_nms_pallas import _make_case
from test_torch_cuda import _greedy_footprint
from test_torch_head import _select_case

torch.set_num_threads(1)


def _anchors():
    rng = np.random.default_rng(2)
    return np.sort(rng.uniform(0.05, 0.9, (2, 3, 2)).astype(np.float32))[:, ::-1]


def _specs(name):
    """(JAX spec, port spec) built from the same arguments."""
    if name == "voc":
        return JC.voc_spec(), TC.voc_spec()
    args = ((224, 320), ((7, 10), (14, 20)), 6, _anchors())
    return JC.YoloSpec.create(*args), TC.YoloSpec.create(*args)


def _preds(spec, bsz, seed, std=2.0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, std, (bsz, h, w, spec.nanchors, 5 + spec.class_num))
            .astype(np.float32) for h, w in spec.out_hws]


@functools.lru_cache(maxsize=None)
def _jax_decode(spec, class_softmax):
    def one(preds, hw):
        return JD.decode_outputs(preds, spec, hw, class_softmax)
    return jax.jit(jax.vmap(one))


def _assert_results_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("class_softmax", [False, True])
@pytest.mark.parametrize("spec_name", ["c6", "voc"])
def test_decode_outputs_matches_jax(spec_name, class_softmax):
    """Scores rtol 1e-6.  Boxes rtol 1e-6 and atol 1e-4 pixels: a corner is
    centre - extent / 2 of two values of up to a few hundred pixels, so one
    ulp of exp or sigmoid moves a corner near 0 by ~3e-5 pixels, which no
    relative tolerance bounds."""
    jspec, tspec = _specs(spec_name)
    preds = _preds(tspec, 3, seed=0)
    hws = np.random.default_rng(1).integers(100, 512, (3, 2)).astype(np.int32)
    want_b, want_s = _jax_decode(jspec, class_softmax)(
        [jnp.asarray(p) for p in preds], jnp.asarray(hws))
    got_b, got_s = TD.decode_outputs([torch.from_numpy(p) for p in preds],
                                     tspec, torch.from_numpy(hws),
                                     class_softmax)
    n = TD.num_candidates(tspec)
    assert n == JD.num_candidates(jspec)
    assert got_b.shape == (3, n, 4) and got_s.shape == (3, n, tspec.class_num)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-6,
                               atol=1e-4)


def _nms_case(seed, n=200, c=6, sparse=True, ties=False):
    """tests/test_nms_pallas.py's ``_make_case``; ``ties`` sets every third
    candidate of every class to one score."""
    boxes, scores = _make_case(seed, n, c, sparse)
    if ties:
        scores[::3] = 0.875
    return boxes, scores


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _jax_batched_nms(boxes, scores, score_thresh, iou_thresh, max_out, top_k):
    return JN.batched_nms(boxes, scores, score_thresh, iou_thresh, max_out,
                          top_k)


@pytest.mark.parametrize("seed,sparse,ties,top_k", [
    (0, True, False, 64), (2, False, False, 200), (3, False, True, 200),
    (5, False, True, 64)])
def test_batched_nms_matches_jax(seed, sparse, ties, top_k):
    """The same keep sets, scores and boxes; ties go to the lower index."""
    cases = [_nms_case(seed + i, sparse=sparse, ties=ties) for i in range(2)]
    boxes = np.stack([b for b, _ in cases])
    scores = np.stack([s for _, s in cases])
    want = _jax_batched_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.7,
                            0.45, 30, top_k)
    got = TN.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                         0.7, 0.45, 30, top_k=top_k)
    assert np.asarray(want.valid).any()
    _assert_results_equal(got, want)


def test_per_class_nms_matches_jax():
    boxes, scores = _nms_case(1, n=60, c=4, sparse=False, ties=True)
    want = JN.per_class_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5, 0.4,
                            10)
    got = TN.per_class_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                           0.5, 0.4, 10)
    assert got.boxes.shape == (40, 4) and np.asarray(want.valid).any()
    _assert_results_equal(got, want)


def _pallas_cases():
    out = {}
    for name, seed, sparse in (("sparse0", 0, True), ("sparse1", 1, True),
                               ("dense2", 2, False), ("dense3", 3, False)):
        out[name] = (*_nms_case(seed, sparse=sparse), 0.7, 0.45)
    # tests/test_nms_pallas.py's early-exit cases, scores as [N, C]
    for case, stop in (("sparse", 0.7), ("empty", 0.7), ("dense", 0.01)):
        boxes, scores = _select_case(case)
        out[f"exit_{case}"] = (boxes, np.ascontiguousarray(scores.T), stop,
                               0.3)
    boxes, scores = _nms_case(11, n=64, c=3)
    scores[:, 2] = np.nan
    out["nan_row"] = (boxes, scores, 0.7, 0.45)
    boxes, scores = _nms_case(7)
    out["empty"] = (boxes, scores * 0.0 + 0.1, 0.7, 0.3)
    return out


PALLAS_CASES = _pallas_cases()


@pytest.mark.parametrize("case", sorted(PALLAS_CASES))
def test_batched_nms_pallas_matches_jax_interpret(case):
    """Exact, on a batch of the case and a second image (its boxes moved)."""
    boxes, scores, thresh, iou = PALLAS_CASES[case]
    boxes = np.stack([boxes, boxes[::-1] + 3.0])
    scores = np.stack([scores, scores[::-1]])
    want = JNP.batched_nms_pallas(jnp.asarray(boxes), jnp.asarray(scores),
                                  thresh, iou, 30, interpret=True)
    got = TNP.batched_nms_pallas(torch.from_numpy(boxes),
                                 torch.from_numpy(scores), thresh, iou, 30)
    _assert_results_equal(got, want)
    valid = got.valid.numpy().reshape(2, scores.shape[-1], 30)
    assert valid.any() == (case != "empty" and case != "exit_empty")
    if case == "nan_row":
        assert not valid[:, 2].any() and valid[:, :2].any()


@pytest.mark.parametrize("thresh", [0.7, 0.25, 0.01])
@pytest.mark.parametrize("case", ["dense", "ties"])
def test_dropping_scores_below_the_threshold_keeps_the_result(case, thresh):
    """The rule the kernel's live list rests on: a candidate below the
    threshold can never be selected, so setting its score to -inf before
    the loop gives, through the plain version, exactly what JAX's
    interpreted kernel gives on the unchanged scores."""
    boxes, scores = _select_case(case)
    boxes = np.stack([boxes, boxes[::-1] + 3.0])
    scores = np.stack([scores.T, scores.T[::-1]])
    want = JNP.batched_nms_pallas(jnp.asarray(boxes), jnp.asarray(scores),
                                  thresh, 0.3, 30, interpret=True)
    dropped = np.where(scores < thresh, -np.inf, scores).astype(np.float32)
    assert (dropped == -np.inf).any()
    got = TNP.batched_nms_pallas_reference(torch.from_numpy(boxes),
                                           torch.from_numpy(dropped), thresh,
                                           0.3, 30)
    assert got.valid.any()
    _assert_results_equal(got, want)


def test_batched_nms_pallas_max_out_100_matches_jax():
    boxes, scores = _nms_case(3, sparse=False)
    want = JNP.batched_nms_pallas(jnp.asarray(boxes)[None],
                                  jnp.asarray(scores)[None], 0.01, 0.45, 100,
                                  interpret=True)
    got = TNP.batched_nms_pallas(torch.from_numpy(boxes)[None],
                                 torch.from_numpy(scores)[None], 0.01, 0.45,
                                 100)
    assert got.valid.shape == (1, 600)
    assert int(got.valid.sum()) > 6 * 30     # some rows keep over 30
    _assert_results_equal(got, want)


@pytest.mark.parametrize("class_softmax", [False, True])
def test_two_stage_matches_fused_head(class_softmax):
    """decode_outputs -> batched_nms_pallas against the port's fused head,
    as tests/test_yolo_head_pallas.py holds the JAX pair."""
    _, spec = _specs("c6")
    preds = [torch.from_numpy(p) for p in _preds(spec, 3, seed=0)]
    hws = torch.from_numpy(np.random.default_rng(1).integers(
        100, 512, (3, 2)).astype(np.int32))
    thresh = 0.05 if class_softmax else 0.3
    fused = TH.fused_decode_nms(preds, spec, hws, thresh, 0.45, 30,
                                class_softmax)
    boxes, scores = TD.decode_outputs(preds, spec, hws, class_softmax)
    two = TNP.batched_nms_pallas(boxes, scores, thresh, 0.45, 30)
    assert fused.valid.any()
    np.testing.assert_array_equal(two.valid.numpy(), fused.valid.numpy())
    np.testing.assert_array_equal(two.classes.numpy(), fused.classes.numpy())
    np.testing.assert_allclose(two.scores.numpy(), fused.scores.numpy(),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(two.boxes.numpy(), fused.boxes.numpy(),
                               rtol=1e-3, atol=0.05)
    # the export program's NMS keeps the same sets
    xla = TN.batched_nms(boxes, scores, thresh, 0.45, 30,
                         top_k=TD.num_candidates(spec))
    np.testing.assert_array_equal(xla.valid.numpy(), two.valid.numpy())
    np.testing.assert_array_equal(xla.scores.numpy(), two.scores.numpy())
    np.testing.assert_array_equal(xla.boxes.numpy(), two.boxes.numpy())


def test_batched_nms_pallas_cpu_path_does_not_launch_and_others_raise():
    boxes, scores = _nms_case(0)
    before = TNP.batched_nms_pallas.launches
    TNP.batched_nms_pallas(torch.from_numpy(boxes)[None],
                           torch.from_numpy(scores)[None])
    assert TNP.batched_nms_pallas.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        TNP.batched_nms_pallas(torch.zeros((1, 5, 4), device="meta"),
                               torch.zeros((1, 5, 2), device="meta"))


@pytest.mark.parametrize("limit", [0, 48 * 1024, 100_000, 232_448, 10**9])
def test_rows_per_block_matches_a_scan(limit):
    """The wrappers' choice of G against a scan of every G: the fewest rows
    on the busiest SM, then the largest G, among the G that fit (at most
    32, the kernels' limit)."""
    for batch, classes, n, sms in ((128, 20, 1050, 132), (32, 20, 1050, 132),
                                   (1, 20, 1050, 132), (8, 20, 4410, 132),
                                   (3, 1, 64, 132), (5, 80, 200, 16)):
        fits = [g for g in range(1, min(classes, 32) + 1)
                if _greedy_footprint(n, g) <= limit]

        def busiest(g):
            return math.ceil(batch * math.ceil(classes / g) / sms) * g

        want = max(fits, key=lambda g: (-busiest(g), g), default=0)
        got = TNP.rows_per_block(batch, classes, sms,
                                 lambda g: _greedy_footprint(n, g), limit, 32)
        assert got == want, (batch, classes, n, sms)
    if limit == 232_448:      # the H100's opt-in limit: the served shapes
        pick = functools.partial(TNP.rows_per_block, classes=20, sms=132,
                                 limit=limit, max_rows=32)
        assert pick(128, footprint=lambda g: _greedy_footprint(1050, g)) == 20
        assert pick(32, footprint=lambda g: _greedy_footprint(1050, g)) == 5
        assert pick(1, footprint=lambda g: _greedy_footprint(1050, g)) == 1
        assert TNP.own_capacity(_greedy_footprint, limit) >= 11618


H100_SMEM = 232_448     # an H100's opt-in shared memory a block, in bytes


@pytest.mark.parametrize("n", [1050, 4410, 11622, 11623, 22743, 72828])
def test_greedy_plan_follows_the_footprint(n):
    """The wrappers' choice of layout against the footprint arithmetic, on
    an H100 (132 SMs, 227 KB a block): the rows stay in shared memory while
    one G's footprint fits (G > 1 shares the boxes, G == 1 keeps 20 bytes a
    candidate, which fits up to 11,622), and go to global scratch above,
    where every G fits and ``rows_per_block`` picks among all of them.
    Today's shapes keep their layout: N=1,050 at G=20 (B=128) and 5 (B=32),
    N=4,410 at G=5."""
    for batch in (128, 32, 8, 1):
        plan = TNP.greedy_plan(batch, 20, 132,
                               lambda g: _greedy_footprint(n, g), H100_SMEM,
                               32)
        if 20 * n > H100_SMEM:
            # every G fits on the global path
            want = ("global", TNP.rows_per_block(batch, 20, 132, lambda g: 0,
                                                 0, 32))
        elif n * (20 + 6 * 2) > H100_SMEM or batch * 20 <= 132:
            want = ("own", 1)
        else:
            want = ("shared", TNP.rows_per_block(
                batch, 20, 132, lambda g: _greedy_footprint(n, g), H100_SMEM,
                32))
        assert plan == want, (batch, n)
    on_global = n > 11_622
    assert TNP.own_capacity(_greedy_footprint, H100_SMEM) == 11_622
    assert (TNP.greedy_plan(128, 20, 132, lambda g: _greedy_footprint(n, g),
                            H100_SMEM, 32)[0] == "global") == on_global
    if n == 1050:
        assert TNP.greedy_plan(128, 20, 132, lambda g: _greedy_footprint(
            n, g), H100_SMEM, 32) == ("shared", 20)
        assert TNP.greedy_plan(32, 20, 132, lambda g: _greedy_footprint(
            n, g), H100_SMEM, 32) == ("shared", 5)
    if n == 4410:
        assert TNP.greedy_plan(128, 20, 132, lambda g: _greedy_footprint(
            n, g), H100_SMEM, 32) == ("shared", 5)
    if on_global:
        # the global G at the batches phase 18 serves
        assert [TNP.global_rows(b, 20, 132, 32) for b in (128, 8, 1)] == [
            20, 2, 1]


def test_library_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """A library is named by its source, every csrc/*.cuh and the flags, so
    an edit to the shared header alone names a new library (and a build)."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.source_digest(n) for n in ("yolo_head", "nms")}
    header = csrc / "greedy_select.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.source_digest(n) for n in ("yolo_head", "nms")}
    assert all(before[n] != after[n] for n in before)
    assert _build.source_digest("rotate3shear") == _build.source_digest(
        "rotate3shear")

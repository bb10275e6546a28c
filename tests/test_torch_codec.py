"""The port's box geometry, letterbox box maps and label codec against the
JAX package, on the same numpy inputs.

Everything here is elementwise fp32 in the same operation order on both
sides, or integer scatter logic, so the comparisons are exact; only the
grid transforms, through sigmoid / exp / log, are held at rtol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from k210_yolo_framework_tpu import config as JConfig
from k210_yolo_framework_tpu.ops import boxes as JB
from k210_yolo_framework_tpu.ops import codec as JC
from k210_yolo_framework_tpu.ops import letterbox as JLB
from k210_yolo_framework_tpu_torch import config as TConfig
from k210_yolo_framework_tpu_torch.ops import boxes as TB
from k210_yolo_framework_tpu_torch.ops import codec as TC
from k210_yolo_framework_tpu_torch.ops import letterbox as TLB

torch.set_num_threads(1)

# the same spec for each package: JSPEC goes to JAX functions, TSPEC to the
# port's
_SPEC_ARGS = ((64, 96), ((2, 3), (4, 6)), 3, np.asarray(JConfig.VOC_ANCHORS))
JSPEC = JConfig.YoloSpec.create(*_SPEC_ARGS)
TSPEC = TConfig.YoloSpec.create(*_SPEC_ARGS)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_boxes_match_jax():
    rng = np.random.default_rng(0)
    wh_a = rng.uniform(0.01, 1, (5, 1, 2)).astype(np.float32)
    wh_b = rng.uniform(0.01, 1, (1, 6, 2)).astype(np.float32)
    _eq(TB.centered_iou(_t(wh_a), _t(wh_b)), JB.centered_iou(wh_a, wh_b))
    pxy = rng.uniform(0, 1, (2, 3, 3, 2)).astype(np.float32)
    pwh = rng.uniform(0.01, 0.5, (2, 3, 3, 2)).astype(np.float32)
    vxy = rng.uniform(0, 1, (7, 2)).astype(np.float32)
    vwh = rng.uniform(0.01, 0.5, (7, 2)).astype(np.float32)
    _eq(TB.iou_xywh(*map(_t, (pxy, pwh, vxy, vwh))),
        JB.iou_xywh(pxy, pwh, vxy, vwh))
    b = rng.uniform(0, 1, (4, 6, 4)).astype(np.float32)
    for in_hw in (None, (224, 320)):
        _eq(TB.center_to_corner(_t(b), in_hw), JB.center_to_corner(b, in_hw))
        _eq(TB.corner_to_center(_t(b), in_hw), JB.corner_to_center(b, in_hw))


def test_letterbox_boxes_and_correct_boxes_match_jax():
    """Batched over mixed image sizes, against the JAX per-image maps."""
    rng = np.random.default_rng(1)
    hws = np.array([[72, 96], [40, 96], [72, 30], [55, 71], [500, 333]],
                   np.int32)
    boxes = np.concatenate([rng.integers(0, 3, (5, 9, 1)),
                            rng.uniform(0, 1, (5, 9, 4))], -1).astype(
                                np.float32)
    want = jax.vmap(lambda b, hw: JLB.letterbox_boxes(b, hw, JSPEC.in_hw))(
        boxes, hws)
    _eq(TLB.letterbox_boxes(_t(boxes), _t(hws), JSPEC.in_hw), want)

    xy = rng.uniform(0, 1, (5, 2, 3, 3, 2)).astype(np.float32)
    wh = rng.uniform(0.01, 1, (5, 2, 3, 3, 2)).astype(np.float32)
    want = jax.vmap(lambda a, b, hw: JLB.correct_boxes(a, b, JSPEC.in_hw, hw))(
        xy, wh, hws)
    _eq(TLB.correct_boxes(_t(xy), _t(wh), JSPEC.in_hw, _t(hws)), want)


def _edge_boxes(seed):
    """[3, MAX_BOXES, 5] boxes with the encode's edge cases, and valid."""
    rng = np.random.default_rng(seed)
    m = JC.MAX_BOXES
    boxes = np.zeros((3, m, 5), np.float32)
    boxes[..., 0] = rng.integers(0, 3, (3, m))
    boxes[..., 1:3] = rng.uniform(0, 1, (3, m, 2))
    boxes[..., 3:5] = rng.uniform(0.02, 0.9, (3, m, 2))
    valid = np.zeros((3, m), bool)
    valid[:, :20] = True
    # image 0: three boxes in one (cell, anchor) slot with other classes:
    # the last payload wins, the class bits accumulate
    boxes[0, 1] = [1, 0.30, 0.30, 0.20, 0.25]
    boxes[0, 2] = [2, 0.31, 0.32, 0.20, 0.25]
    boxes[0, 3] = [0, 0.32, 0.31, 0.20, 0.25]
    # x == 1.0 and y == 1.0 index one past the grid: dropped, and they must
    # not count in another box's collision test
    boxes[0, 4] = [1, 1.0, 0.5, 0.2, 0.2]
    boxes[0, 5] = [2, 0.0, 0.5, 0.2, 0.2]   # the cell x == 1.0 would alias
    boxes[1, 6] = [0, 0.5, 1.0, 0.3, 0.3]
    # a negative class wraps, a class past the last is dropped
    boxes[1, 7, 0] = -1
    boxes[1, 8, 0] = 3
    # padded rows with content but not valid write nothing
    boxes[2, 20:] = boxes[2, :m - 20]
    valid[2, :2] = False
    return boxes, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_encode_labels_matches_jax_exactly(seed):
    boxes, valid = _edge_boxes(seed)
    want = JC.encode_labels_batch(jnp.asarray(boxes), jnp.asarray(valid), JSPEC)
    got = TC.encode_labels_batch(_t(boxes), _t(valid), TSPEC)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _eq(g, w)
    # the collision slot of image 0 holds three class bits
    bits = torch.cat([g[0, ..., 5:].sum(-1).flatten() for g in got])
    assert (bits == 3).any()
    one = TC.encode_labels(_t(boxes[1]), _t(valid[1]), TSPEC)
    for g, o in zip(got, one):
        assert torch.equal(g[1], o)


@pytest.mark.parametrize("seed", [0, 1])
def test_encode_labels_three_layers_matches_jax_exactly(seed):
    """The darknet53 yolo's label encode: 3 layers, 9 anchors (each box to
    its best anchor over all nine, then that anchor's layer and cell)."""
    rng = np.random.default_rng(10 + seed)
    anchors = np.sort(rng.uniform(0.02, 0.9, (3, 3, 2)), axis=None)[::-1]
    args = ((64, 96), ((2, 3), (4, 6), (8, 12)), 3, anchors.reshape(3, 3, 2))
    jspec, tspec = JConfig.YoloSpec.create(*args), TConfig.YoloSpec.create(*args)
    boxes, valid = _edge_boxes(seed)
    boxes[..., 3:5] = rng.uniform(0.01, 0.95, boxes[..., 3:5].shape)
    want = JC.encode_labels_batch(jnp.asarray(boxes), jnp.asarray(valid), jspec)
    got = TC.encode_labels_batch(_t(boxes), _t(valid), tspec)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want] == [
        (3, 2, 3, 3, 8), (3, 4, 6, 3, 8), (3, 8, 12, 3, 8)]
    for g, w in zip(got, want):
        _eq(g, w)
    # every layer receives boxes
    assert all(float(g[..., 4].sum()) > 0 for g in got)


def test_assign_anchor_and_pad_boxes_match_jax():
    rng = np.random.default_rng(3)
    wh = rng.uniform(0.01, 1, (40, 2)).astype(np.float32)
    wh[5] = wh[6] = JSPEC.anchors_np()[1, 0]     # exact anchor: a tie-free hit
    anchors = JSPEC.anchors_np()
    got = TC.assign_anchor(_t(wh), _t(anchors))
    want = JC.assign_anchor(jnp.asarray(wh), jnp.asarray(anchors))
    for g, w in zip(got, want):
        _eq(g, w)
    raw = rng.uniform(0, 1, (70, 5))
    for a, b in zip(TC.pad_boxes(raw), JC.pad_boxes(raw)):
        _eq(a, b)


def test_decode_labels_and_grid_transforms_match_jax():
    boxes, valid = _edge_boxes(4)
    labels = JC.encode_labels_batch(jnp.asarray(boxes), jnp.asarray(valid),
                                    JSPEC)
    for b in range(3):
        mine = [lab[b] for lab in labels]
        want = JC.decode_labels(mine, JSPEC, 0.5, max_boxes=12)
        got = TC.decode_labels([_t(np.asarray(m)) for m in mine], TSPEC, 0.5,
                               max_boxes=12)
        for g, w in zip(got, want):
            _eq(g, w)
    rng = np.random.default_rng(5)
    for layer, (h, w) in enumerate(JSPEC.out_hws):
        xy = rng.normal(0, 2, (2, h, w, 3, 2)).astype(np.float32)
        wh = rng.normal(0, 1, (2, h, w, 3, 2)).astype(np.float32)
        for g, w_ in zip(TC.xywh_grid_to_all(_t(xy), _t(wh), layer, TSPEC),
                         JC.xywh_grid_to_all(xy, wh, layer, JSPEC)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-6)
        axy = rng.uniform(0, 1, (2, h, w, 3, 2)).astype(np.float32)
        awh = rng.uniform(0, 1, (2, h, w, 3, 2)).astype(np.float32)
        awh[0, 0] = 0.0                              # empty cells: -inf
        for g, w_ in zip(TC.xywh_all_to_grid(_t(axy), _t(awh), layer, TSPEC),
                         JC.xywh_all_to_grid(axy, awh, layer, JSPEC)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-6)

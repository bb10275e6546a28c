"""The port's ``compat.Helper`` against the JAX package's, method for method
(the counterparts of ``tests/test_compat.py``), and the one-image augment
``ops/augment.augment_image_and_boxes`` with JAX's draws injected.

A small synthetic set (``data.pipeline.synthetic_ann_list``: the same
files and rows from both packages) and the VOC anchors at 64x96, grids 2x3
and 4x6.  Tolerances: the letterbox may move a pixel by one uint8 level,
1/max after normalising (``tests/test_torch_augment.py``); the augment in
fp32 as there (images atol 1e-3, boxes rtol 1e-6, valid exact); labels
rtol 1e-6; the label codec, drawing and the box transforms exact.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from k210_yolo_framework_tpu import compat as JCompat
from k210_yolo_framework_tpu import config as JConfig
from k210_yolo_framework_tpu.data import pipeline as JPL
from k210_yolo_framework_tpu.ops import augment as JA
from k210_yolo_framework_tpu_torch import compat as TCompat
from k210_yolo_framework_tpu_torch.data import pipeline as TPL
from k210_yolo_framework_tpu_torch.ops import augment as TA
from k210_yolo_framework_tpu_torch.ops import rotate_pallas as TR

torch.set_num_threads(1)

IN_HW = (64, 96)
OUT_HW = np.array([[2, 3], [4, 6]])


@pytest.fixture(scope="module")
def helpers(tmp_path_factory):
    root = tmp_path_factory.mktemp("compat")
    ann = TPL.synthetic_ann_list(str(root), n=10, class_num=20, seed=4)
    np.save(root / "ann.npy", ann)
    np.save(root / "anchor.npy", np.asarray(JConfig.VOC_ANCHORS, np.float32))
    args = (str(root / "ann.npy"), 20, str(root / "anchor.npy"), IN_HW,
            OUT_HW)
    return (JCompat.Helper(*args, validation_split=0.2),
            TCompat.Helper(*args, validation_split=0.2, device="cpu"))


def _rows_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert str(x[0]) == str(y[0])
        np.testing.assert_array_equal(x[1], y[1])


def test_split_like_reference(helpers):
    jh, th = helpers
    _rows_equal(th.train_list, jh.train_list)
    _rows_equal(th.test_list, jh.test_list)
    assert len(th.test_list) == int(10 * 0.2)
    np.testing.assert_array_equal(th.anchors, jh.anchors)
    assert th.spec.out_hws == ((2, 3), (4, 6))
    flat = TCompat.Helper(None, 20, None, IN_HW, [2, 3, 4, 6], device="cpu")
    assert flat.spec is None and flat.train_list is None


def test_box_label_roundtrip(helpers):
    jh, th = helpers
    boxes = np.array([[3.0, 0.4, 0.5, 0.2, 0.3],
                      [11.0, 0.7, 0.3, 0.1, 0.15]], np.float32)
    got, want = th.box_to_label(boxes), jh.box_to_label(boxes)
    assert [g.shape for g in got] == [(2, 3, 3, 25), (4, 6, 3, 25)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    back = th.label_to_box(got)
    np.testing.assert_array_equal(back, jh.label_to_box(want))
    np.testing.assert_allclose(back[np.argsort(back[:, 0])], boxes,
                               atol=1e-5)


def test_process_img(helpers):
    jh, th = helpers
    row = th.train_list[0]
    img = th._read_img(str(row[0]))
    np.testing.assert_array_equal(img, jh._read_img(str(row[0])))
    got, got_boxes = th._process_img(img, np.copy(row[1]),
                                     is_training=False, is_resize=True)
    want, want_boxes = jh._process_img(img, np.copy(row[1]),
                                       is_training=False, is_resize=True)
    assert got.shape == (*IN_HW, 3) and got.dtype == np.float32
    assert 0.99 <= got.max() <= 1.0
    assert np.abs(got - want).max() <= 1.0 / 255 + 1e-6
    np.testing.assert_allclose(got_boxes, want_boxes, rtol=1e-6, atol=1e-7)
    # without resize: /max of the image itself
    raw, _ = th._process_img(img, is_resize=False)
    np.testing.assert_allclose(raw, jh._process_img(img, is_resize=False)[0],
                               rtol=1e-6)


def test_process_img_training_draws_afresh(helpers):
    """No generator given: a fresh split of a SeedSequence-seeded
    generator per call, never one fixed transform; a generator given
    fixes it."""
    _, th = helpers
    row = th.train_list[1]
    img = th._read_img(str(row[0]))
    outs = [th._process_img(img, np.copy(row[1]), is_training=True)[0]
            for _ in range(4)]
    assert any(not np.array_equal(outs[0], o) for o in outs[1:])
    seeded = [th._process_img(img, np.copy(row[1]), is_training=True,
                              generator=torch.Generator().manual_seed(1))
              for _ in range(2)]
    np.testing.assert_array_equal(seeded[0][0], seeded[1][0])
    np.testing.assert_array_equal(seeded[0][1], seeded[1][1])
    assert seeded[0][0].shape == (*IN_HW, 3) and seeded[0][1].shape[1] == 5


def _key_for_branch(branch: int, hw):
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        if int(JA._branch_matrices(key, hw)[1]) == branch:
            return key
    raise AssertionError("no key")


@pytest.mark.parametrize("branch", [0, 1, 2])
def test_augment_image_and_boxes_matches_jax(branch):
    """JAX's draws for one image rebuilt from its key and injected; each
    branch (flip, rotate, translate)."""
    rng = np.random.default_rng(branch)
    img = rng.uniform(0, 255, (*IN_HW, 3)).astype(np.float32)
    boxes = np.concatenate([rng.integers(0, 20, (6, 1)),
                            rng.uniform(0.1, 0.9, (6, 2)),
                            rng.uniform(0.05, 0.5, (6, 2))], -1).astype(
        np.float32)
    valid = rng.uniform(size=6) < 0.8
    key = _key_for_branch(branch, IN_HW)
    want = jax.jit(JA.augment_image_and_boxes)(
        key, jnp.asarray(img), jnp.asarray(boxes), jnp.asarray(valid))
    _, b, flip, theta, (tx, ty) = JA._branch_matrices(key, IN_HW)

    def one(v, dtype):
        return torch.tensor([np.asarray(v).item()], dtype=dtype)

    params = TA.AugmentParams(torch.zeros(1, dtype=torch.int64),
                              one(b, torch.int64), one(flip, torch.bool),
                              one(theta, torch.float32),
                              one(tx, torch.float32), one(ty, torch.float32))
    before = TR.rotate_3shear.launches
    got = TA.augment_image_and_boxes(torch.from_numpy(img),
                                     torch.from_numpy(boxes),
                                     torch.from_numpy(valid), params=params)
    assert TR.rotate_3shear.launches == before     # CPU: the plain version
    assert got[0].shape == img.shape
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_datasets(helpers, monkeypatch):
    """Both Helpers' first test and train batches (thread loaders, the
    same rows for the same seed), without augment."""
    jh, th = helpers
    monkeypatch.setattr(JPL, "DataPipeline", functools.partial(
        JPL.DataPipeline, use_native=False))
    monkeypatch.setattr(TPL, "DataPipeline", functools.partial(
        TPL.DataPipeline, use_native=False))
    jh.set_dataset(batch_size=4, rand_seed=1, is_training=False)
    th.set_dataset(batch_size=4, rand_seed=1, is_training=False)
    assert th.train_epoch_step == jh.train_epoch_step == 8 // 4
    assert th.test_epoch_step == jh.test_epoch_step == 0
    for name in ("train_dataset", "test_dataset"):
        imgs, labels = next(getattr(th, name))
        want_imgs, want_labels = next(getattr(jh, name))
        assert imgs.shape == (4, *IN_HW, 3) and imgs.device.type == "cpu"
        assert labels[0].shape == (4, 2, 3, 3, 25)
        diff = np.abs(imgs.numpy() - np.asarray(want_imgs))
        assert diff.max() <= 1.0 / 255 + 1e-6
        for g, w in zip(labels, want_labels):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=0)
    th.set_dataset(batch_size=4, rand_seed=1, is_training=True)
    imgs, labels = next(th.train_dataset)
    assert imgs.shape == (4, *IN_HW, 3) and float(imgs.max()) <= 1.0


def test_draw_box_and_transforms(helpers):
    jh, th = helpers
    img = np.zeros((100, 200, 3), np.uint8)
    tb = np.array([[0.0, 0.5, 0.5, 0.3, 0.4], [5.0, 0.2, 0.3, 0.2, 0.2]],
                  np.float32)
    out = th.draw_box(img, tb)
    assert out.shape == img.shape and out.any() and not img.any()
    np.testing.assert_array_equal(out, jh.draw_box(img, tb))

    xywh = np.array([[0.5, 0.5, 0.2, 0.4], [0.3, 0.6, 0.1, 0.2]], np.float32)
    for scale in (True, False):
        corner = th.center_to_corner(xywh, to_all_scale=scale)
        np.testing.assert_array_equal(
            corner, jh.center_to_corner(xywh, to_all_scale=scale))
        back = th.corner_to_center(corner, from_all_scale=scale)
        np.testing.assert_array_equal(
            back, jh.corner_to_center(corner, from_all_scale=scale))
        np.testing.assert_allclose(back, xywh, rtol=1e-6, atol=1e-7)

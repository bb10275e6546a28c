"""The port's own copies of the numpy-only ``config`` and ``utils/colormap``
against the JAX package's, field by field and method by method."""

import dataclasses

import numpy as np
import pytest

from k210_yolo_framework_tpu import config as JC
from k210_yolo_framework_tpu.utils import colormap as JCM
from k210_yolo_framework_tpu_torch import config as TC
from k210_yolo_framework_tpu_torch.utils import colormap as TCM

ANCHORS3 = np.sort(np.random.default_rng(1).uniform(0.05, 0.9, (3, 3, 2)))[
    :, ::-1]
SPEC_ARGS = {
    "voc": None,
    "three_layer": ((224, 320), ((7, 10), (14, 20), (28, 40)), 20, ANCHORS3),
    "small": ((64, 96), ((2, 3), (4, 6)), 3, np.asarray(JC.VOC_ANCHORS)),
}


def _pair(name):
    if SPEC_ARGS[name] is None:
        return JC.voc_spec(), TC.voc_spec()
    return (JC.YoloSpec.create(*SPEC_ARGS[name]),
            TC.YoloSpec.create(*SPEC_ARGS[name]))


def _fields(obj):
    return [(f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj)]


@pytest.mark.parametrize("name", sorted(SPEC_ARGS))
def test_yolo_spec_matches_jax(name):
    jspec, tspec = _pair(name)
    # the port's one field more, darknet's per-layer scale_x_y: empty
    # (1 on every layer) in every spec made as the JAX package makes it
    assert _fields(tspec) == _fields(jspec) + [("scale_x_y", ())]
    assert type(tspec).__module__ == "k210_yolo_framework_tpu_torch.config"
    for prop in ("nlayers", "nanchors", "nchannels"):
        assert getattr(tspec, prop) == getattr(jspec, prop)
    for meth in ("anchors_np", "out_hw_np"):
        got, want = getattr(tspec, meth)(), getattr(jspec, meth)()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for layer in range(jspec.nlayers):
        for meth in ("grid_wh", "xy_offset", "wh_scale"):
            got, want = getattr(tspec, meth)(layer), getattr(jspec, meth)(layer)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
    assert tspec.label_shapes() == jspec.label_shapes()
    assert tspec.label_shapes(8) == jspec.label_shapes(8)
    # frozen and hashable: per-device constants are cached on the spec
    assert hash(tspec) == hash(TC.YoloSpec.create(
        tspec.in_hw, tspec.out_hws, tspec.class_num, tspec.anchors))
    with pytest.raises(dataclasses.FrozenInstanceError):
        tspec.class_num = 1


def test_from_files_and_create_guards_match_jax(tmp_path):
    path = tmp_path / "anchors.npy"
    np.save(path, ANCHORS3)
    grids = ((7, 10), (14, 20), (28, 40))
    assert _fields(TC.YoloSpec.from_files(str(path), out_hws=grids)) \
        == _fields(JC.YoloSpec.from_files(str(path), out_hws=grids)) \
        + [("scale_x_y", ())]
    for args, match in ((((224, 320), grids, 20, ANCHORS3[0]), "anchors"),
                        (((224, 320), grids[:2], 20, ANCHORS3), "grids")):
        for mod in (TC, JC):
            with pytest.raises(ValueError, match=match):
                mod.YoloSpec.create(*args)


def test_voc_anchors_train_config_and_colormap_match_jax():
    assert TC.VOC_ANCHORS == JC.VOC_ANCHORS
    assert _fields(TC.TrainConfig()) == _fields(JC.TrainConfig())
    assert _fields(TC.TrainConfig(batch_size=128, augment=False)) \
        == _fields(JC.TrainConfig(batch_size=128, augment=False))
    assert TCM.COLORMAP == JCM.COLORMAP and len(TCM.COLORMAP) == 80

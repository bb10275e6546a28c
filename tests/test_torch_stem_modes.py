"""The port's serving stem variants (``Predictor(stem_mode=...)``,
``ConvBN.stem_mode``, ``ops/letterbox.letterbox_stem_patches``) against
the JAX package's, after ``tests/test_stem_modes.py``.

Tolerances:
* patches: equal to the port's own default letterbox, padded and
  extracted by hand, bit for bit (the same resample columns contracted in
  the same order); against JAX's ``letterbox_stem_patches`` within one
  level in 1% of the taps, the letterbox parity of
  ``test_torch_letterbox.py``;
* serving: detections as sets (``utils/detmatch.assert_detections_close``
  at its defaults) between the port's mode and JAX's ``default``; the
  port's ``nativeconv`` equals its ``default`` exactly in the float modes
  (the same conv);
* the single image: the JAX test's rtol 1e-4 / atol 1e-5 on scores, rtol
  1e-3 / atol 1e-2 on boxes;
* ``nativeconv`` with ``int8_act_cal``: calibrated ranges rtol 1e-5 (the
  recording forward is fp32 in both), detections as sets with matched
  scores within 0.01 (``test_torch_quantize.py``'s bounds).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from k210_yolo_framework_tpu import config as JConfig
from k210_yolo_framework_tpu.inference import Predictor as JaxPredictor
from k210_yolo_framework_tpu.models.layers import ConvBN as JConvBN
from k210_yolo_framework_tpu.models.layers import Int8Act as JInt8Act
from k210_yolo_framework_tpu.models.layers import leaky_relu as jleaky_relu
from k210_yolo_framework_tpu.ops import letterbox as JLB
from k210_yolo_framework_tpu.training.checkpoint import _path_key
from k210_yolo_framework_tpu_torch import config as TConfig
from k210_yolo_framework_tpu_torch.inference import (
    Predictor,
    stack_detections,
)
from k210_yolo_framework_tpu_torch.models import layers as TL
from k210_yolo_framework_tpu_torch.ops import letterbox as LB
from k210_yolo_framework_tpu_torch.training import checkpoint as TC
from k210_yolo_framework_tpu_torch.utils.detmatch import (
    assert_detections_close,
)

from torch_parity import jax_weights, port_net

torch.set_num_threads(1)

ANCHORS = np.array([[[0.7, 0.6], [0.5, 0.5], [0.4, 0.3]],
                    [[0.3, 0.3], [0.2, 0.2], [0.15, 0.15]]], np.float32)
_SPEC_ARGS = ((64, 64), ((2, 2), (4, 4)), 4, ANCHORS)
JSPEC = JConfig.YoloSpec.create(*_SPEC_ARGS)
TSPEC = TConfig.YoloSpec.create(*_SPEC_ARGS)
KW = dict(obj_thresh=0.05, iou_thresh=0.45)


def _manual_patches(imgs: torch.Tensor, k=3, s=2, p=1) -> torch.Tensor:
    """[B, H, W, C] -> [B, Ho, k, Wo, k, C] zero-padded patches by hand."""
    b, h, w, c = imgs.shape
    ho, wo = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    xp = torch.nn.functional.pad(imgs, (0, 0, p, p, p, p))
    out = torch.zeros((b, ho, k, wo, k, c), dtype=imgs.dtype)
    for i in range(ho):
        for dy in range(k):
            for j in range(wo):
                out[:, i, dy, j] = xp[:, s * i + dy, s * j:s * j + k]
    return out


@pytest.mark.parametrize("hw", [(240, 320), (180, 320), (240, 200)],
                         ids=["full", "short", "narrow"])
def test_letterbox_stem_patches_matches_manual_extraction(hw):
    """Patches == the default letterbox, stored as uint8, zero-padded and
    extracted by hand (border taps included), in fp32 and bf16; and JAX's
    patches within the letterbox parity."""
    rng = np.random.default_rng(3)
    canvas = np.zeros((2, 240, 320, 3), np.uint8)
    canvas[:, :hw[0], :hw[1]] = rng.integers(0, 256, (2, *hw, 3))
    hws = torch.tensor([hw, hw], dtype=torch.int32)
    in_hw = (96, 128)
    c = torch.from_numpy(canvas)
    for dtype in (torch.float32, torch.bfloat16):
        base = LB.letterbox_image(c, hws, in_hw, dtype).to(torch.uint8)
        got = LB.letterbox_stem_patches(c, hws, in_hw, dtype=dtype).to(
            torch.uint8)
        assert got.shape == (2, 48, 3, 64, 3, 3)
        assert torch.equal(got, _manual_patches(base)), dtype
    want = np.asarray(JLB.letterbox_stem_patches(
        jnp.asarray(canvas[0]), jnp.asarray(hw, jnp.int32), in_hw)
        .astype(jnp.uint8))
    got = LB.letterbox_stem_patches(c, hws, in_hw).to(torch.uint8)[0].numpy()
    diff = np.abs(got.astype(np.int16) - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01


def _scene(seed=0, b=8):
    """Canvases of 64x64 holding images whose letterbox scale into 64x64
    is exact (1 or 2: the JAX Predictor's jitted letterbox departs from the
    eager one at inexact scales, ROADMAP fault q)."""
    rng = np.random.default_rng(seed)
    hws = np.array([[64, 64], [32, 32], [64, 32], [32, 64]] * (b // 4),
                   np.int32)
    canvases = np.zeros((len(hws), 64, 64, 3), np.uint8)
    for i, (h, w) in enumerate(hws):
        canvases[i, :h, :w] = rng.integers(0, 256, (h, w, 3))
    return canvases, hws


def _predictors(name, stem_mode, jax_stem_mode="default", **kw):
    jnet, variables, flat = jax_weights(name, (64, 64), 3, 4, alpha=0.5)
    jp = JaxPredictor(jnet, dict(variables), JSPEC, compute_dtype=jnp.float32,
                      stem_mode=jax_stem_mode, **KW, **kw)
    tp = Predictor(port_net(name, (64, 64), 3, 4, 0.5),
                   TC.state_dict_from_flat(flat), TSPEC,
                   compute_dtype=torch.float32, stem_mode=stem_mode,
                   device="cpu", **KW, **kw)
    return jp, tp


@pytest.mark.parametrize("name", ["yolo_mobilev1", "yolo_mobilev2"])
def test_patches_stem_serving_matches_jax_default(name):
    """The port in ``patches`` serves what JAX's default stem serves (as
    sets), batch and single image."""
    jp, tp = _predictors(name, "patches")
    canvases, hws = _scene()
    got = tp.predict_batch(canvases, hws)
    n_a, _ = assert_detections_close(stack_detections(got), stack_detections(
        jp.predict_batch(canvases, hws)))
    assert n_a > 20
    assert_detections_close(stack_detections([tp.predict_image(canvases[0])]),
                            stack_detections([jp.predict_image(canvases[0])]))


def test_nativeconv_stem_matches_default():
    """``nativeconv`` runs the default's conv in the float modes: the port's
    two modes agree exactly, and with JAX's ``nativeconv`` as sets."""
    jp, tp = _predictors("yolo_mobilev1", "nativeconv", "nativeconv")
    _, base = _predictors("yolo_mobilev1", "default")
    canvases, hws = _scene(seed=1)
    got = stack_detections(tp.predict_batch(canvases, hws))
    want = stack_detections(base.predict_batch(canvases, hws))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    n_a, _ = assert_detections_close(got, stack_detections(
        jp.predict_batch(canvases, hws)))
    assert n_a > 20


def _refusal(make):
    with pytest.raises(ValueError) as info:
        make()
    return str(info.value)


def test_patches_stem_rejects_unsupported_builders_and_modes():
    """The three refusals, each in JAX's words."""
    cases = [("tiny_yolo", dict(stem_mode="patches"), "stride-2 stem"),
             ("yolo", dict(stem_mode="patches"), "stride-2 stem"),
             ("yolo_mobilev1", dict(stem_mode="patches",
                                    quantize="int8_act"), "quantize"),
             ("yolo_mobilev2", dict(stem_mode="patches",
                                    quantize="int8_act_cal"), "quantize"),
             ("yolo_mobilev1", dict(stem_mode="bogus"), "unknown stem_mode")]
    for name, kw, match in cases:
        jnet, variables, flat = jax_weights(name, (64, 64), 3, 4, alpha=0.5)
        net = port_net(name, (64, 64), 3, 4, 0.5)
        got = _refusal(lambda: Predictor(net, None, TSPEC, device="cpu",
                                         **kw))
        want = _refusal(lambda: JaxPredictor(jnet, variables, JSPEC, **kw))
        assert match in got and got == want, (name, kw)
    # patches with int8 weights and the float modes are accepted
    Predictor(port_net("yolo_mobilev1", (64, 64), 3, 4, 0.5), None, TSPEC,
              stem_mode="patches", quantize="int8", device="cpu")


def test_patches_stem_is_chosen_by_the_stem_geometry():
    """``patches`` follows the stem conv, not the builder's name: a renamed
    subclass of a stride-2 builder is served, and the same net with a
    stride-1 stem is refused in JAX's words, naming its class."""
    net = port_net("yolo_mobilev1", (64, 64), 3, 4, 0.5)
    net.__class__ = type("RenamedDetector", (type(net),), {})
    assert Predictor(net, None, TSPEC, stem_mode="patches",
                     device="cpu").stem_mode == "patches"
    for strides, pads in (((1, 1), ((1, 1), (1, 1))),
                          ((2, 2), ((1, 0), (1, 0)))):
        net.stem.conv.strides, net.stem.conv.pads = strides, pads
        got = _refusal(lambda: Predictor(net, None, TSPEC,
                                         stem_mode="patches", device="cpu"))
        assert got == ("stem_mode='patches' needs a builder with a stride-2 "
                       "stem (yolo_mobilev1/yolo_mobilev2); RenamedDetector's"
                       " stride-1 stem would inflate pixel traffic ~9x")


def test_patches_stem_single_image_path():
    """predict_image under ``patches`` against the default stem (the JAX
    test's tolerances)."""
    _, base = _predictors("yolo_mobilev1", "default")
    _, pats = _predictors("yolo_mobilev1", "patches")
    img = np.random.default_rng(2).integers(0, 256, (100, 128, 3)).astype(
        np.uint8)
    a, b = base.predict_image(img), pats.predict_image(img)
    assert a.boxes.shape == b.boxes.shape and len(a.scores) > 0
    np.testing.assert_allclose(a.scores, b.scores, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(a.boxes, b.boxes, rtol=1e-3, atol=1e-2)


def test_nativeconv_int8_act_cal_carries_the_stem_range():
    """Under ``int8_act_cal`` the ``nativeconv`` stem computes int8 and is
    calibrated, as in JAX: the same ranges (the stem's among them), and the
    same detections as sets; JAX's ranges brought across serve alike."""
    jp, tp = _predictors("yolo_mobilev1", "nativeconv", "nativeconv",
                         quantize="int8_act_cal")
    calib, calib_hws = _scene(seed=4)
    jp.calibrate(calib, calib_hws)
    tp.calibrate(calib, calib_hws)
    want = {"act_ranges/" + _path_key(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jp.variables["act_ranges"])[0]}
    got = TC.act_ranges_flat(tp.net)
    stem = "act_ranges/backbone/stem/conv/min"
    assert stem in want and sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7)
    canvases, hws = _scene()
    want_dets = stack_detections(jp.predict_batch(canvases, hws))
    n_a, _ = assert_detections_close(
        stack_detections(tp.predict_batch(canvases, hws)), want_dets,
        score_tol=0.01)
    assert n_a > 20
    # the default stem stays wide and holds no range
    _, wide = _predictors("yolo_mobilev1", "default",
                          quantize="int8_act_cal")
    wide.calibrate(calib, calib_hws)
    assert stem not in TC.act_ranges_flat(wide.net)
    fresh = _predictors("yolo_mobilev1", "nativeconv", "nativeconv",
                        quantize="int8_act_cal")[1]
    TC.load_act_ranges(fresh.net, want)
    assert np.asarray(fresh.net.backbone.stem.conv.act_max) == want[
        stem.replace("/min", "/max")]
    assert_detections_close(
        stack_detections(fresh.predict_batch(canvases, hws)), want_dets,
        score_tol=0.01)


def test_stem_conv_int8_dispatch_follows_jax():
    """A 3-channel ConvBN under a static Int8Act: flax's holds an
    ``act_ranges`` entry with ``nativeconv`` and none with ``default``; the
    port's is int8 exactly then."""
    x = jnp.zeros((2, 16, 16, 3), jnp.float32)
    for mode in ("default", "nativeconv"):
        j = JConvBN(features=8, kernel=(3, 3), strides=(2, 2),
                    explicit_pad=((1, 1), (1, 1)), act=jleaky_relu(0.3),
                    dtype=JInt8Act(static=True), stem_mode=mode)
        held = "act_ranges" in j.init(jax.random.PRNGKey(0), x)
        t = TL.ConvBN(3, 8, (3, 3), (2, 2), explicit_pad=((1, 1), (1, 1)),
                      act=TL.leaky_relu(0.3), stem_mode=mode)
        assert t.conv.int8_capable == held == (mode == "nativeconv")
    with pytest.raises(ValueError, match="unknown stem_mode"):
        TL.ConvBN(3, 8, stem_mode="im2col")


def test_predictor_leaves_the_callers_net_as_it_was():
    """A Predictor sets the mode on its own copy: the caller's net keeps
    its stem, and a default Predictor built after a ``patches`` one on the
    same net serves the default stem."""
    _, _, flat = jax_weights("yolo_mobilev1", (64, 64), 3, 4, alpha=0.5)
    net = port_net("yolo_mobilev1", (64, 64), 3, 4, 0.5, flat)
    pats = Predictor(net, None, TSPEC, stem_mode="patches", device="cpu",
                     **KW)
    assert net.stem_mode == "default" and pats.net.stem_mode == "patches"
    after = Predictor(net, None, TSPEC, device="cpu", **KW)
    fresh = Predictor(port_net("yolo_mobilev1", (64, 64), 3, 4, 0.5, flat),
                      None, TSPEC, device="cpu", **KW)
    assert after.net.stem_mode == "default"
    canvases, hws = _scene(seed=5)
    with torch.inference_mode():
        x = torch.from_numpy(canvases)
        h = torch.from_numpy(hws)
        for g, w in zip(after._forward_batch(x, h),
                        fresh._forward_batch(x, h)):
            assert torch.equal(g, w)
        # a net set to patches by its caller is served by its own stem mode
        net.stem_mode = "patches"
        again = Predictor(net, None, TSPEC, device="cpu", **KW)
        assert again.net.stem_mode == "default"
        for g, w in zip(again._forward_batch(x, h),
                        fresh._forward_batch(x, h)):
            assert torch.equal(g, w)

"""The port's darknet builders (tiny_yolo, the darknet53 yolo) and their
blocks against the JAX package's, and fault c (the SAME max-pool).

Weights from ``torch_parity.jax_weights`` / ``draw_flat`` (the JAX
variable shapes, leaves drawn from a numpy seed).  tiny_yolo runs at
96x96, 3 anchors, 3 classes: its stride-1 pool sees a 3x3 map, so the
-inf pad after the last row and column decides the border outputs.  The
full darknet53 ``yolo`` runs once at 64x64 (grids 2x2, 4x4, 8x8); its
blocks run narrow (``_ResBlockBody`` at 16 filters, ``LastLayers`` at 8).

Tolerances: fp32 eval rtol / atol 1e-5 (``test_forward_matches_jax_fp32``'s)
for tiny_yolo and the blocks; the whole yolo (75 convs) rtol 1e-5 / atol
3e-5: measured 1.8e-5 at most, where the port's and JAX's own distances
from the port's float64 forward are 1.7e-5 and 8.2e-6.  bf16 and train
mode as in ``test_torch_mobilenet_v2.py`` (tiny_yolo's bf16 ratios over 4
seeds: 1.03-1.07x and 0.97-1.00x; with BN started in bf16 1.21-1.27x and
1.34-1.37x); the pool exact (a max of the same values); the Predictor's
detections as sets
(``utils/detmatch.assert_detections_close``, its default bounds).

The yolo Predictor is held twice to the JAX package: to the JAX
``Predictor`` itself at letterbox scales 1 and 2, and to its serving
stages run one by one (``letterbox_image`` under ``vmap``, the net,
``fused_decode_nms``) at a scale of 2/3 (72x96 canvases into 64x64).
There the JAX Predictor's jitted letterbox departs from the same letterbox
run eagerly in 9,360 of 36,864 pixels, by up to 255 levels, on XLA:CPU
(fault q): under jit the centring offset ``in - img * scale`` is fused
into one multiply-add, so 64 - 72 x fp32(2/3) gives 15.999998, whose half
truncates to 7, where the eager product rounds to 48 and gives 8: the
picture moves by one row.  The port's letterbox equals the eager one; at
scales whose products are exact the two JAX programs agree.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from k210_yolo_framework_tpu import config as JConfig
from k210_yolo_framework_tpu.models import build_network as jax_build
from k210_yolo_framework_tpu.models import darknet as JD
from k210_yolo_framework_tpu_torch import config as TConfig
from k210_yolo_framework_tpu_torch.inference import (
    Predictor,
    stack_detections,
)
from k210_yolo_framework_tpu_torch.models import darknet as TD
from k210_yolo_framework_tpu_torch.models.layers import max_pool_same
from k210_yolo_framework_tpu_torch.training import checkpoint as TC
from k210_yolo_framework_tpu_torch.utils.detmatch import (
    assert_detections_close,
)

from torch_parity import (
    assert_train_mode_close,
    bf16_errors,
    draw_flat,
    jax_weights,
    port_net,
    to_t,
    train_mode_vs_jax,
    unflatten,
)

torch.set_num_threads(1)

TINY_HW, NANCHORS, CLASSES = (96, 96), 3, 3
YOLO_HW = (64, 64)


def _nchw(x):
    return to_t(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def images(seed, in_hw, b=2):
    x = np.random.default_rng(seed).integers(0, 256, (b, *in_hw, 3))
    x = x.astype(np.uint8)
    return x, (1.0 / x.reshape(b, -1).max(1)).astype(np.float32)


@pytest.mark.parametrize("content", ["mixed", "negative", "nan"])
@pytest.mark.parametrize("hw", [(4, 6), (5, 7), (3, 3)])
@pytest.mark.parametrize("stride", [1, 2])
def test_max_pool_same_matches_flax(stride, hw, content):
    """Fault c: flax's 2x2 SAME pool pads -inf after only; a symmetric or a
    zero pad changes the border maxima of a negative map.  NaN spreads to
    every window that holds it, on both sides."""
    x = np.random.default_rng(3).normal(0, 1, (2, *hw, 4)).astype(np.float32)
    if content == "negative":
        x = -np.abs(x) - 1.0
    elif content == "nan":
        x[0, hw[0] - 1, hw[1] - 1, 0] = np.nan
        x[1, 0, 0, 2] = np.nan
    want = np.asarray(fnn.max_pool(jnp.asarray(x), (2, 2), (stride, stride),
                                   padding="SAME"))
    got = _nhwc(max_pool_same(_nchw(x), stride))
    assert got.shape == want.shape == (2, -(-hw[0] // stride),
                                       -(-hw[1] // stride), 4)
    np.testing.assert_array_equal(got, want)
    if content == "negative" and stride == 1:
        # the last row and column hold their own maxima, not a pad's 0
        assert (got[:, -1] < 0).all() and (got[:, :, -1] < 0).all()
    if content == "nan":
        assert np.isnan(got[0, -1, -1, 0]) and np.isnan(got[1, 0, 0, 2])


def test_tiny_eval_forward_matches_jax_fp32():
    _, variables, flat = jax_weights("tiny_yolo", TINY_HW, NANCHORS, CLASSES)
    jnet = jax_build("tiny_yolo", TINY_HW, NANCHORS, CLASSES)
    x, scale = images(1, TINY_HW)
    want = jax.jit(lambda v, a, s: jnet.apply(v, a, input_scale=s))(
        variables, jnp.asarray(x), jnp.asarray(scale))
    with torch.inference_mode():
        got = port_net("tiny_yolo", TINY_HW, NANCHORS, CLASSES, 1.0, flat)(
            to_t(x), input_scale=to_t(scale))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want] == [
        (2, 3, 3, 3, 8), (2, 6, 6, 3, 8)]
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(w[0] - w[1]).mean() > 1e-3   # the image matters
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)


def test_tiny_eval_forward_matches_jax_bf16():
    port_err, jax_err, apart = bf16_errors(
        "tiny_yolo", TINY_HW, NANCHORS, CLASSES, 1.0, *images(1, TINY_HW, 4))
    assert port_err <= 1.3 * jax_err and apart <= 1.3 * jax_err, (
        port_err / jax_err, apart / jax_err)


@pytest.mark.parametrize("witness", ["smooth", "as_built"])
def test_tiny_train_mode_matches_jax(witness, monkeypatch):
    """B=4, fp32: outputs, running statistics (momentum 0.99) and every
    gradient (on the smooth witness) against ``jax.vjp``."""
    smooth = witness == "smooth"
    res = train_mode_vs_jax("tiny_yolo", TINY_HW, NANCHORS, CLASSES, 1.0,
                            monkeypatch=monkeypatch if smooth else None)
    assert len(res["moves"][1]) == 2 * (8 + 3)
    assert_train_mode_close(res, smooth, out_limit=5e-5, move_limit=5e-5)


def _block_pair(jax_mod, port_mod, x, seed):
    """The same drawn weights in a flax module and its port; both outputs
    in eval mode, NHWC."""
    shapes = jax.eval_shape(
        lambda: jax_mod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    flat = draw_flat(shapes, seed)
    want = jax.jit(jax_mod.apply)(unflatten(flat), jnp.asarray(x))
    port_mod.load_state_dict(TC.state_dict_from_flat(flat, port_mod))
    with torch.inference_mode():
        got = port_mod.eval()(_nchw(x), torch.float32)
    return got, want


def test_resblock_body_matches_flax():
    """A stride-2 ``down`` conv (top/left pad) on an odd 9x11 map, then two
    residual units, at 16 filters."""
    x = np.random.default_rng(4).normal(0, 1, (2, 9, 11, 8)).astype(
        np.float32)
    got, want = _block_pair(JD._ResBlockBody(16, 2),
                            TD._ResBlockBody(8, 16, 2), x, seed=2)
    assert got.shape == (2, 16, 4, 5) and want.shape == (2, 4, 5, 16)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_last_layers_matches_flax():
    x = np.random.default_rng(5).normal(0, 1, (2, 4, 6, 12)).astype(
        np.float32)
    got, want = _block_pair(JD.LastLayers(8), TD.LastLayers(12, 8), x,
                            seed=3)
    for g, w, c in zip(got, want, (8, 16)):
        assert g.shape == (2, c, 4, 6)
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def _yolo():
    return jax_weights("yolo", YOLO_HW, NANCHORS, CLASSES)


def test_yolo_eval_forward_matches_jax_fp32():
    """The whole darknet53 yolo, three scales, fp32 at 64x64."""
    jnet, variables, flat = _yolo()
    x, scale = images(1, YOLO_HW)
    want = jax.jit(lambda v, a, s: jnet.apply(v, a, input_scale=s))(
        variables, jnp.asarray(x), jnp.asarray(scale))
    net = port_net("yolo", YOLO_HW, NANCHORS, CLASSES, 1.0, flat)
    assert net.n_out_layers == jnet.n_out_layers == 3
    with torch.inference_mode():
        got = net(to_t(x), input_scale=to_t(scale))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want] == [
        (2, 2, 2, 3, 8), (2, 4, 4, 3, 8), (2, 8, 8, 3, 8)]
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(w[0] - w[1]).mean() > 1e-3
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=3e-5)


def _yolo_scene(hws, canvas_hw):
    """The spec's arguments (three scales, seeded anchors) and canvases of
    ``canvas_hw`` holding random images of the sizes ``hws``."""
    rng = np.random.default_rng(1)
    anchors = np.sort(rng.uniform(0.05, 0.9, (3, 3, 2)))[:, ::-1]
    args = (YOLO_HW, ((2, 2), (4, 4), (8, 8)), CLASSES, anchors)
    hws = np.array(hws, np.int32)
    canvases = np.zeros((len(hws), *canvas_hw, 3), np.uint8)
    for b, (h, w) in enumerate(hws):
        canvases[b, :h, :w] = rng.integers(0, 256, (h, w, 3))
    return args, hws, canvases


def _yolo_predictor(flat, args):
    return Predictor(port_net("yolo", YOLO_HW, NANCHORS, CLASSES),
                     TC.state_dict_from_flat(flat),
                     TConfig.YoloSpec.create(*args), obj_thresh=0.2,
                     iou_thresh=0.45, device="cpu")


def test_yolo_predictor_matches_the_jax_predictor():
    """The three-scale Predictor on the CPU (the plain head, 84 candidates)
    against the JAX ``Predictor`` in fp32, ``predict_batch`` on 64x64
    canvases (scale 1) and ``predict_image`` on a 128x128 image (scale
    0.5), detections as sets."""
    from k210_yolo_framework_tpu.inference import Predictor as JaxPredictor

    jnet, variables, flat = _yolo()
    args, hws, canvases = _yolo_scene([[64, 64], [40, 64], [64, 30],
                                       [32, 16]], YOLO_HW)
    jp = JaxPredictor(jnet, variables, JConfig.YoloSpec.create(*args),
                      obj_thresh=0.2, iou_thresh=0.45)
    tp = _yolo_predictor(flat, args)
    got, want = tp.predict_batch(canvases, hws), jp.predict_batch(canvases,
                                                                  hws)
    assert all(len(d.scores) > 0 for d in got)
    n_got, n_want = assert_detections_close(stack_detections(got),
                                            stack_detections(want))
    assert n_got == sum(len(d.scores) for d in got)
    img = np.random.default_rng(2).integers(0, 256, (128, 128, 3)).astype(
        np.uint8)
    got1, want1 = tp.predict_image(img), jp.predict_image(img)
    assert len(got1.scores) > 0
    assert_detections_close(stack_detections([got1]),
                            stack_detections([want1]))


def test_yolo_predictor_matches_jax():
    """The three-scale Predictor on the CPU (the plain head, 84 candidates)
    against the JAX package's letterbox, net and fused head run one by one
    on the same canvases, at a letterbox scale of 2/3 (fault q),
    detections as sets."""
    from k210_yolo_framework_tpu.ops import letterbox as JLB
    from k210_yolo_framework_tpu.ops.yolo_head_pallas import fused_decode_nms

    jnet, variables, flat = _yolo()
    args, hws, canvases = _yolo_scene([[72, 96], [40, 96], [72, 30]],
                                      (72, 96))

    imgs = jax.vmap(lambda c, hw: JLB.letterbox_image(
        c, hw, YOLO_HW).astype(jnp.uint8))(jnp.asarray(canvases),
                                           jnp.asarray(hws))
    scale = 1.0 / jnp.maximum(jnp.max(imgs, axis=(1, 2, 3)).astype(
        jnp.float32), 1e-12)
    preds = jax.jit(lambda v, a, s: jnet.apply(v, a, input_scale=s))(
        variables, imgs, scale)
    jspec = JConfig.YoloSpec.create(*args)
    want = jax.jit(lambda p, h: fused_decode_nms(p, jspec, h, 0.2, 0.45,
                                                 30))(preds, jnp.asarray(hws))

    got = _yolo_predictor(flat, args).predict_batch(canvases, hws)
    assert all(len(d.scores) > 0 for d in got)
    n_got, n_want = assert_detections_close(
        stack_detections(got), type(want)(*(np.asarray(a) for a in want)))
    assert n_got == n_want == sum(len(d.scores) for d in got)

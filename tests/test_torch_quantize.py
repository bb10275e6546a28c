"""The port's quantized serving against the JAX package: ``quantize.py``,
the int8 conv of ``models/layers.py`` (``Int8Act``), the quantized
``Predictor`` modes, calibration, ``eval.calibrate_from_rows`` and
``utils.quantize_mode``.

Tolerances:
* ``quantize_state`` equals JAX's ``quantize_tree`` (run op by op, the
  arithmetic as written) bit for bit, through the bridge;
* one int8 conv against flax's ``_Int8Conv`` under ``jax.jit``: within
  one activation quantum per output, ``sx * sw[o] * sum|kq[o]|`` (a jitted
  scale may sit an ulp away, XLA turning ``/ 127`` into ``* (1 / 127)``,
  and flip a rounding), and equal where no rounding flipped;
* whole Predictors: fp32 and ``int8`` logits within 1e-5 absolute (only
  the summation order differs); in the int8-activation modes the two
  packages' float paths differ by ulps, which flips a few activation
  roundings by one quantum each, and each flip moves every later layer:
  logits within 2.5% of the largest logit at worst and 0.5% on average
  (measured: 1.2% and 0.3%); detections at set level, matched scores
  within 0.01;
* calibrated ranges: rtol 1e-5 (the recording forward is fp32 in both).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from k210_yolo_framework_tpu import config as JConfig
from k210_yolo_framework_tpu.inference import Predictor as JaxPredictor
from k210_yolo_framework_tpu.models.layers import _Int8Conv
from k210_yolo_framework_tpu.ops import letterbox as JLB
from k210_yolo_framework_tpu.quantize import QTensor as JQTensor
from k210_yolo_framework_tpu.quantize import quantize_tree
from k210_yolo_framework_tpu.training.checkpoint import _path_key
from k210_yolo_framework_tpu.utils import quantize_mode as jax_quantize_mode
from k210_yolo_framework_tpu_torch import config as TConfig
from k210_yolo_framework_tpu_torch.data import pipeline as TPL
from k210_yolo_framework_tpu_torch.eval import calibrate_from_rows
from k210_yolo_framework_tpu_torch.inference import (
    Predictor,
    stack_detections,
)
from k210_yolo_framework_tpu_torch.models.layers import Conv, Int8Act
from k210_yolo_framework_tpu_torch.quantize import (
    QTensor,
    dequantize_state,
    fake_quant_state,
    is_quantized,
    quantize_state,
    quantize_tree as port_quantize_tree,
)
from k210_yolo_framework_tpu_torch.training import checkpoint as TC
from k210_yolo_framework_tpu_torch.utils import quantize_mode
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
KW = dict(obj_thresh=0.3, iou_thresh=0.45)
ACT_MODES = ("int8_act", "int8_act_sym", "int8_act_cal")


def _weights(name="yolo_mobilev1"):
    return jax_weights(name, (64, 64), 3, 4, alpha=0.5)


def _scene(seed=0):
    """8 canvases of 64x64 holding images whose letterbox scale into 64x64
    is exact (1 or 2: the JAX Predictor's jitted letterbox departs from
    the eager one at inexact scales, ROADMAP fault q)."""
    rng = np.random.default_rng(seed)
    hws = np.array([[64, 64], [32, 32], [64, 32], [32, 64]] * 2, np.int32)
    canvases = np.zeros((len(hws), 64, 64, 3), np.uint8)
    for b, (h, w) in enumerate(hws):
        canvases[b, :h, :w] = rng.integers(0, 256, (h, w, 3))
    return canvases, hws


def _predictors(mode, name="yolo_mobilev1", **kw):
    jnet, variables, flat = _weights(name)
    jp = JaxPredictor(jnet, dict(variables), JSPEC, compute_dtype=jnp.float32,
                      quantize=mode, **KW, **kw)
    tp = Predictor(port_net(name, (64, 64), 3, 4, 0.5),
                   TC.state_dict_from_flat(flat), TSPEC,
                   compute_dtype=torch.float32, quantize=mode, device="cpu",
                   **KW, **kw)
    return jp, tp


def _jax_logits(jp, canvases, hws):
    """The JAX Predictor's serving forward up to the head (its
    ``_run_batch`` before ``fused_decode_nms``)."""
    def fwd(variables, canv, hw):
        variables = jp._materialize(variables)
        imgs = jax.vmap(lambda c, h: JLB.letterbox_image(
            c, h, JSPEC.in_hw, dtype=jnp.float32).astype(jnp.uint8))(canv, hw)
        inv = 1.0 / jnp.maximum(
            jnp.max(imgs, axis=(1, 2, 3)).astype(jnp.float32), 1e-12)
        return jp.net.apply(variables, imgs, input_scale=inv)
    return [np.asarray(p, np.float32)
            for p in jax.jit(fwd)(jp.variables, canvases, hws)]


# ---- quantize.py ------------------------------------------------------------

@pytest.mark.parametrize("name", ["yolo_mobilev1", "yolo_mobilev2",
                                  "tiny_yolo", "yolo"])
def test_quantize_state_matches_quantize_tree(name):
    _, variables, flat = _weights(name)
    want = quantize_tree(variables["params"])
    sd = TC.state_dict_from_flat(flat)
    got = quantize_state(sd)
    by_key = {TC.native_key(k, v.ndim): k for k, v in sd.items()}
    leaves = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, JQTensor))[0]
    n_q = 0
    for path, leaf in leaves:
        t = got[by_key["params/" + _path_key(path)]]
        if isinstance(leaf, JQTensor):
            n_q += 1
            assert isinstance(t, QTensor) and t.q.dtype == torch.int8
            assert t.scale.shape == (t.q.shape[0], 1, 1, 1)
            np.testing.assert_array_equal(t.q.permute(2, 3, 1, 0).numpy(),
                                          np.asarray(leaf.q))
            np.testing.assert_array_equal(t.scale.reshape(-1).numpy(),
                                          np.asarray(leaf.scale).reshape(-1))
        else:
            assert not isinstance(t, QTensor)
            np.testing.assert_array_equal(t.numpy().reshape(-1),
                                          np.asarray(leaf).reshape(-1))
    # every conv kernel (stem, depthwise, dense, biased head) and no other
    assert n_q == sum(k.endswith(".weight") and v.ndim == 4
                      for k, v in sd.items()) > 0
    assert is_quantized(got) and not is_quantized(sd)
    assert port_quantize_tree is quantize_state
    deq = dequantize_state(got)
    for k, v in sd.items():
        if isinstance(got[k], QTensor):   # |error| <= half a step
            assert torch.all((deq[k] - v).abs() <= got[k].scale / 2 + 1e-7)
        else:
            assert torch.equal(deq[k], v)
    assert all(torch.equal(a, b) for a, b in
               zip(fake_quant_state(sd).values(), deq.values()))


# ---- the int8 conv ----------------------------------------------------------

CONV_CASES = {
    # (kernel, strides, flax padding, port pads, input pad before flax)
    "1x1": ((1, 1), (1, 1), "SAME", ((0, 0), (0, 0)), None),
    "3x3_same": ((3, 3), (1, 1), "SAME", ((1, 1), (1, 1)), None),
    "3x3_s2_pad": ((3, 3), (2, 2), "VALID", ((1, 0), (1, 0)),
                   ((0, 0), (1, 0), (1, 0), (0, 0))),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
@pytest.mark.parametrize("mode", ["affine", "symmetric", "static"])
def test_int8_conv_matches_flax(case, mode):
    kernel, strides, padding, pads, pre = CONV_CASES[case]
    rng = np.random.default_rng(7)
    # skewed, as after a LeakyReLU: the zero point is not 0
    x = rng.uniform(-0.2, 1.5, (2, 9, 11, 12)).astype(np.float32)
    k = (rng.standard_normal((*kernel, 12, 16)) / np.sqrt(9 * 12)
         ).astype(np.float32)
    affine, static = mode != "symmetric", mode == "static"
    jmod = _Int8Conv(features=16, kernel=kernel, strides=strides,
                     padding=padding, out_dtype=jnp.float32,
                     affine_act=affine, static_act=static)
    variables = {"params": {"kernel": jnp.asarray(k)}}
    rmin, rmax = np.float32(-0.15), np.float32(1.3)  # static: x saturates
    if static:
        variables["act_ranges"] = {"min": jnp.asarray(rmin),
                                   "max": jnp.asarray(rmax)}
    xj = jnp.asarray(x) if pre is None else jnp.pad(jnp.asarray(x), pre)
    want = np.asarray(jax.jit(jmod.apply)(variables, xj))

    conv = Conv(12, 16, kernel, strides, pads)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(k).permute(3, 2, 0, 1))
        if static:
            lo, hi = conv.act_ranges("cpu")
            lo.fill_(float(rmin))
            hi.fill_(float(rmax))
        got = conv.forward_int8(
            torch.from_numpy(x).permute(0, 3, 1, 2),
            Int8Act(torch.float32, affine=affine, static=static))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape

    # one activation quantum of each output channel
    sw = np.maximum(np.abs(k).max((0, 1, 2)), 1e-12) / 127.0
    kq = np.clip(np.round(k / sw), -127, 127)
    lo, hi = (rmin, rmax) if static else (x.min(), x.max())
    lo, hi = min(lo, 0.0), max(hi, 0.0)
    sx = (hi - lo) / 254.0 if affine else max(-lo, hi) / 127.0
    quantum = sx * sw * np.abs(kq).sum((0, 1, 2))
    err = np.abs(got - want)
    assert np.all(err <= quantum * 1.001 + 1e-6), (err / quantum).max()
    assert (err > 1e-5).mean() < 0.05


def test_int8_conv_zero_point_folds_exactly():
    """The zp padding and the correction term are exact: the int8 conv
    equals an fp32 conv over the dequantized activations and weights,
    zero-padded (a padded zp dequantizes to exactly 0)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(-0.2, 1.5, (2, 12, 7, 9)).astype(
        np.float32))
    for kernel, pads, strides in (((3, 3), ((1, 1), (1, 1)), (1, 1)),
                                  ((3, 3), ((1, 0), (1, 0)), (2, 2)),
                                  ((1, 1), ((0, 0), (0, 0)), (1, 1))):
        conv = Conv(12, 6, kernel, strides, pads)
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(rng.standard_normal(
                conv.weight.shape).astype(np.float32)) * 0.1)
            got = conv.forward_int8(x, Int8Act(torch.float32))
            xf = x.double()
            lo, hi = min(float(xf.min()), 0.0), max(float(xf.max()), 0.0)
            sx = np.float32(max(hi - lo, 1e-6)) / np.float32(254.0)
            zp = np.clip(-127.0 - np.round(np.float32(lo) / sx), -127, 127)
            xq = torch.clamp(torch.round(x / float(sx)) + zp, -127, 127)
            xdq = (xq.double() - zp) * float(sx)
            kf = conv.weight.double()
            sw = kf.abs().amax((1, 2, 3), keepdim=True).clamp_min(1e-12) / 127
            kdq = torch.clamp(torch.round(kf / sw), -127, 127) * sw
            (t, b), (l, r) = pads
            want = torch.nn.functional.conv2d(
                torch.nn.functional.pad(xdq, (l, r, t, b)), kdq,
                stride=strides)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("cin,cout,hw,kernel,strides", [
    (12, 16, (4, 4), (1, 1), (1, 1)),     # 16 rows
    (12, 20, (5, 5), (1, 1), (1, 1)),     # k and n not multiples of 8
    (124, 124, (3, 4), (1, 1), (1, 1)),   # yolo_mobilev2's widths
    (20, 12, (3, 3), (3, 3), (1, 1)),
    (12, 6, (7, 9), (3, 3), (2, 2)),
    (16, 24, (5, 7), (3, 3), (1, 1))])    # no padding needed
def test_int8_product_pads_exactly(cin, cout, hw, kernel, strides):
    """The int8 product pads the im2col to the shapes ``torch._int_mm``
    takes on CUDA (more than 16 rows, k and n multiples of 8) with zeros
    and cuts the result back: equal to an int64 conv of the same int8
    operands."""
    rng = np.random.default_rng(cin * cout)
    conv = Conv(cin, cout, kernel, strides)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(rng.standard_normal(
            conv.weight.shape).astype(np.float32)))
    wq, _, wsum = conv.int8_weight()
    assert wq.shape == (-(-cout // 8) * 8, -(-cin * kernel[0] * kernel[1]
                                             // 8) * 8)
    xq = torch.from_numpy(rng.integers(-127, 128, (2 if hw[0] > 4 else 1,
                                                   cin, *hw)).astype(np.int8))
    got = conv._int8_product(xq, wq)
    kq = wq[:cout, :cin * kernel[0] * kernel[1]].reshape(
        cout, kernel[0], kernel[1], cin).permute(0, 3, 1, 2)
    want = torch.nn.functional.conv2d(xq.double(), kq.double(),
                                      stride=strides)
    assert got.dtype == torch.int32
    assert torch.equal(got.permute(0, 3, 1, 2).double(), want)
    assert torch.equal(wsum, kq.to(torch.int32).sum(dim=(1, 2, 3)))


@pytest.mark.parametrize("mode", ACT_MODES)
def test_predictor_holds_int8_weights_once(mode):
    """In the int8-activation modes the Predictor quantizes each int8
    conv's kernel once, into buffers, and serves exactly what quantizing
    it inside each call serves."""
    _, _, flat = _weights()
    net = port_net("yolo_mobilev1", (64, 64), 3, 4, 0.5)
    p = Predictor(net, TC.state_dict_from_flat(flat), TSPEC, quantize=mode,
                  device="cpu", **KW)
    convs = [m for m in p.net.modules()
             if isinstance(m, Conv) and m.int8_capable]
    assert convs and all(m.int8_wq.dtype == torch.int8 for m in convs)
    canvases, hws = _scene()
    if mode == "int8_act_cal":
        p.calibrate(canvases, hws)
    c, h = torch.from_numpy(canvases), torch.from_numpy(hws)
    with torch.inference_mode():
        held = p._forward_batch(c, h)
        for m in convs:
            for name in ("int8_wq", "int8_sw", "int8_wsum"):
                delattr(m, name)
        per_call = p._forward_batch(c, h)
    for a, b in zip(held, per_call):
        assert torch.equal(a, b)


# ---- Predictor --------------------------------------------------------------

@pytest.mark.parametrize("mode", ["int8", *ACT_MODES])
def test_predictor_matches_jax_predictor(mode):
    jp, tp = _predictors(mode)
    canvases, hws = _scene()
    if mode == "int8_act_cal":
        calib, calib_hws = _scene(seed=1)
        jp.calibrate(calib, calib_hws)
        tp.calibrate(calib, calib_hws)
    want = _jax_logits(jp, canvases, hws)
    with torch.inference_mode():
        got = tp._forward_batch(torch.from_numpy(canvases),
                                torch.from_numpy(hws))
    for g, w in zip(got, want):
        g = g.numpy().reshape(w.shape)
        err = np.abs(g - w)
        if mode == "int8":
            assert err.max() <= 1e-5, err.max()
        else:
            top = np.abs(w).max()
            assert err.max() <= 0.025 * top and err.mean() <= 0.005 * top, (
                err.max() / top, err.mean() / top)
    a = stack_detections(tp.predict_batch(canvases, hws))
    b = stack_detections(jp.predict_batch(canvases, hws))
    n_a, n_b = assert_detections_close(
        a, b, score_tol=1e-3 if mode == "int8" else 0.01)
    assert n_a > 20


def test_int8_predictor_holds_int8_and_equals_fake_quant():
    """quantize='int8' keeps the kernels as int8 plus fp32 scales (no fp32
    copy in the net) and serves exactly what the fake-quantized fp32 state
    serves."""
    _, _, flat = _weights()
    net = port_net("yolo_mobilev1", (64, 64), 3, 4, 0.5)
    sd = TC.state_dict_from_flat(flat)
    q = Predictor(net, sd, TSPEC, quantize="int8", device="cpu", **KW)
    fq = Predictor(net, fake_quant_state(sd), TSPEC, device="cpu", **KW)
    fp = Predictor(net, sd, TSPEC, device="cpu", **KW)
    n_kernels = sum(k.endswith(".weight") and v.ndim == 4
                    for k, v in sd.items())
    assert len(q.qweights) == n_kernels
    assert all(v.q.dtype == torch.int8 and v.scale.dtype == torch.float32
               for v in q.qweights.values())
    assert not any(p.ndim == 4 for p in q.net.parameters())
    kernel_bytes = sum(v.numel() * 4 for k, v in sd.items()
                       if k.endswith(".weight") and v.ndim == 4)
    saved = fp.weight_bytes() - q.weight_bytes()
    assert saved > 0.7 * kernel_bytes
    canvases, hws = _scene()
    for a, b in zip(q.predict_batch(canvases, hws),
                    fq.predict_batch(canvases, hws)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    img = canvases[0]
    for x, y in zip(q.predict_image(img), fq.predict_image(img)):
        np.testing.assert_array_equal(x, y)


def test_calibrate_matches_jax_and_widens():
    jp, tp = _predictors("int8_act_cal")
    calib, calib_hws = _scene(seed=1)
    jp.calibrate(calib, calib_hws)
    tp.calibrate(calib, calib_hws)
    want = {"act_ranges/" + _path_key(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jp.variables["act_ranges"])[0]}
    got = TC.act_ranges_flat(tp.net)
    assert sorted(got) == sorted(want) and len(got) == 2 * sum(
        m.int8_capable for m in tp.net.modules() if isinstance(m, Conv))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7)
    # over two batches the ranges are the union of each batch's alone
    more, more_hws = _scene(seed=2)
    tp.calibrate(more, more_hws)
    both = TC.act_ranges_flat(tp.net)
    alone = _predictors("int8_act_cal")[1].calibrate(more, more_hws)
    alone = TC.act_ranges_flat(alone.net)
    pick = {"min": np.minimum, "max": np.maximum}
    for k in got:
        assert both[k] == pick[k.rsplit("/", 1)[1]](got[k], alone[k]), k
    # JAX's ranges cross by the bridge: the port then serves as JAX does
    fresh = _predictors("int8_act_cal")[1]
    TC.load_act_ranges(fresh.net, want)
    canvases, hws = _scene()
    assert_detections_close(
        stack_detections(fresh.predict_batch(canvases, hws)),
        stack_detections(jp.predict_batch(canvases, hws)), score_tol=0.01)


@pytest.mark.parametrize("name", ["tiny_yolo", "yolo_mobilev2"])
def test_calibrate_from_rows_and_other_builders(tmp_path, name):
    """calibrate_from_rows stages rows as serving does; the SAME 3x3 dense
    convs (tiny_yolo) and the inverted residuals (v2) serve calibrated at
    set level with JAX."""
    from k210_yolo_framework_tpu.eval import (
        calibrate_from_rows as jax_calibrate_from_rows,
    )

    ann = TPL.synthetic_ann_list(str(tmp_path), n=4, class_num=4, seed=3)
    jp, tp = _predictors("int8_act_cal", name=name)
    jax_calibrate_from_rows(jp, ann, canvas_hw=(128, 128))
    calibrate_from_rows(tp, ann, canvas_hw=(128, 128))
    want = {"act_ranges/" + _path_key(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jp.variables["act_ranges"])[0]}
    got = TC.act_ranges_flat(tp.net)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6)
    canvases, hws = _scene()
    assert_detections_close(
        stack_detections(tp.predict_batch(canvases, hws)),
        stack_detections(jp.predict_batch(canvases, hws)), score_tol=0.01)


def test_quantize_guards():
    _, _, flat = _weights()
    net = port_net("yolo_mobilev1", (64, 64), 3, 4, 0.5)
    sd = TC.state_dict_from_flat(flat)
    canvases, hws = _scene()
    # uncalibrated int8_act_cal serving raises, then serves once calibrated
    cal = Predictor(net, sd, TSPEC, quantize="int8_act_cal", device="cpu")
    with pytest.raises(RuntimeError, match="calibrate"):
        cal.predict_batch(canvases, hws)
    with pytest.raises(RuntimeError, match="calibrate"):
        cal.predict_image(canvases[0])
    cal.calibrate(canvases[:2], hws[:2])
    cal.predict_image(canvases[0])
    with pytest.raises(ValueError, match="only applies"):
        Predictor(net, sd, TSPEC, quantize="int8", device="cpu").calibrate(
            canvases, hws)
    # an Int8Act compute dtype implies its mode; a conflict raises
    assert Predictor(net, sd, TSPEC, compute_dtype=Int8Act(),
                     device="cpu").quantize == "int8_act"
    p = Predictor(net, sd, TSPEC, compute_dtype=Int8Act(
        torch.float32, affine=False, static=True), device="cpu")
    assert p.quantize == "int8_act_cal" and not p.int8_act.affine
    assert p.compute_dtype == torch.float32
    assert Predictor(net, sd, TSPEC, compute_dtype=Int8Act(affine=False),
                     device="cpu").quantize == "int8_act_sym"
    with pytest.raises(ValueError, match="conflicting"):
        Predictor(net, sd, TSPEC, compute_dtype=Int8Act(affine=False),
                  quantize="int8_act", device="cpu")
    with pytest.raises(ValueError, match="unknown quantize"):
        Predictor(net, sd, TSPEC, quantize="int4", device="cpu")
    # Int8Act is serving only
    with pytest.raises(NotImplementedError, match="serving-only"):
        net.train()(torch.zeros(1, 64, 64, 3), dtype=Int8Act())
    net.eval()
    assert Int8Act() == Int8Act(torch.bfloat16) != Int8Act(affine=False)
    assert hash(Int8Act()) == hash(Int8Act())


@pytest.mark.parametrize("flag", ["True", "int8", "INT8_ACT", "int8_act_sym",
                                  "int8_act_cal", "False", "none", "",
                                  "0", "no"])
def test_quantize_mode_matches_jax(flag):
    assert quantize_mode(flag) == jax_quantize_mode(flag)


def test_quantize_mode_refuses_typos():
    for flag in ("int8act", "int4"):
        with pytest.raises(ValueError, match="unknown --quantize"):
            quantize_mode(flag)
        with pytest.raises(ValueError):
            jax_quantize_mode(flag)

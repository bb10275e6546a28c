"""YOLOv4 in the port (``models/cspdarknet.py``, ``yolonet.YoloV4``), on the
CPU at 128x128 (grids 4, 8 and 16) with seeded weights, against the plain
reference written from darknet's cfg (``tests/yolov4_reference.py``); the
Mish epilogue's arithmetic; ``scale_x_y`` in the head's geometry and
decode; the refusals (TP/SP, export, training); the net's spans.

The weights: conv kernels N(0, 1 / fan_in), BatchNorm scale U(0.4, 0.6)
and shift N(0.5, 0.25^2), running statistics the reference's own batch
statistics over the test images, and each output conv rescaled so its
channels have mean 0 and spread 0.5 (box) or 1.8 (scores), objectness
shifted by -4: a sane net whose detections depend on the image.
"""

import dataclasses
import functools
import math
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from k210_yolo_framework_tpu_torch.config import YoloSpec, voc_spec
from k210_yolo_framework_tpu_torch.inference import Predictor
from k210_yolo_framework_tpu_torch.models import build_network
from k210_yolo_framework_tpu_torch.models import layers as TL
from k210_yolo_framework_tpu_torch.models import yolonet as TY
from k210_yolo_framework_tpu_torch.ops import conv_epilogue as TE
from k210_yolo_framework_tpu_torch.ops import yolo_head_pallas as TH

sys.path.insert(0, str(Path(__file__).resolve().parent))
import yolov4_reference as R  # noqa: E402

torch.set_num_threads(1)

HW = (128, 128)
GRIDS = ((4, 4), (8, 8), (16, 16))
CLASSES = 20


def _spec(scale_x_y=()):
    return YoloSpec.create(HW, GRIDS, CLASSES, R.anchors(HW), scale_x_y)


def _images(seed, b=2):
    """[b, 128, 128, 3] fp32 images, each scaled to [0, 1] by its max."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((b, *HW, 3), generator=g) ** 2
    return x / x.flatten(1).amax(1).view(-1, 1, 1, 1)


@functools.cache
def _weights():
    """The reference's weights in the cfg's order (module docstring)."""
    g = torch.Generator().manual_seed(0)
    convs = [l for l in R.LAYERS if l["type"] == "conv"]
    weights = []
    for layer, shape in zip(convs, R.conv_shapes(CLASSES)):
        w = torch.randn(shape, generator=g) / math.sqrt(math.prod(shape[1:]))
        if layer["act"] == "linear":
            weights.append({"w": w, "b": torch.zeros(shape[0])})
        else:
            weights.append({
                "w": w, "gamma": 0.4 + 0.2 * torch.rand(shape[0], generator=g),
                "beta": 0.5 + 0.25 * torch.randn(shape[0], generator=g)})
    outs = R.forward(_images(1).permute(0, 3, 1, 2), weights, calibrate=True)
    target = torch.full((5 + CLASSES,), 0.5)
    target[4:] = 1.8
    target = target.repeat(3)
    heads = [w for w, l in zip(weights, convs) if l["act"] == "linear"]
    for wt, o in zip(heads, outs[::-1]):     # heads in the cfg's order
        flat = o.permute(0, 2, 3, 1).reshape(-1, o.shape[1])
        gain = target / flat.std(0).clamp_min(1e-6)
        wt["b"] = (wt["b"] - flat.mean(0)) * gain
        wt["w"] = wt["w"] * gain[:, None, None, None]
        wt["b"][4::5 + CLASSES] -= 4.0
    return weights


@functools.cache
def _net():
    """The port's YoloV4 (eval, no gradients) holding ``_weights()``: its
    ConvBNs in registration order are the cfg's BN convs in order, its
    output convs the cfg's linear ones in reverse (y3, y2, y1)."""
    net = TY.YoloV4(3, CLASSES, HW).eval().requires_grad_(False)
    convbns = iter(m for m in net.modules() if isinstance(m, TL.ConvBN))
    heads = iter([net.y3_out, net.y2_out, net.y1_out])
    with torch.no_grad():
        for wt in _weights():
            if "b" in wt:
                conv = next(heads).dark_conv_out
                conv.weight.copy_(wt["w"])
                conv.bias.copy_(wt["b"])
                continue
            m = next(convbns)
            m.conv.weight.copy_(wt["w"])
            m.bn.weight.copy_(wt["gamma"])
            m.bn.bias.copy_(wt["beta"])
            m.bn.running_mean.copy_(wt["mean"])
            m.bn.running_var.copy_(wt["var"])
    assert next(convbns, None) is None and next(heads, None) is None
    return net


def _rel_errors(got, want):
    """Per output layer ||got - want|| / ||want||, the port's NHWC
    [B, h, w, a, E] against the reference's NCHW [B, a * E, h, w]."""
    out = []
    for p, r in zip(got, want):
        r = r.permute(0, 2, 3, 1).reshape(p.shape)
        out.append(float((p.float() - r).norm() / r.norm()))
    return out


def test_the_reference_is_the_cfg():
    R.check_layers()
    assert R.scale_x_y() == (1.05, 1.1, 1.2)
    np.testing.assert_allclose(R.anchors((608, 608))[0] * 608,
                               [[142, 110], [192, 243], [459, 401]])


def test_the_net_has_the_cfgs_convs_and_grids():
    """110 convs: 72 Mish ConvBNs, 35 leaky ones, 3 biased output convs;
    outputs 19, 38 and 76 at 608 in that order; the cfg's conv shapes in
    its order; ``scale_x_y`` in output order."""
    with torch.device("meta"):
        net = TY.NETWORKS["yolov4"](anchor_num=3, class_num=CLASSES,
                                    in_hw=(608, 608))
        outs = net(torch.zeros((1, 608, 608, 3)))
    convbns = [m for m in net.modules() if isinstance(m, TL.ConvBN)]
    assert sum(m.act is TL.mish for m in convbns) == 72
    assert sum(getattr(m.act, "leaky_alpha", None) == 0.1
               for m in convbns) == 35
    biased = [m for m in net.modules()
              if isinstance(m, TL.Conv) and m.bias is not None]
    assert len(convbns) + len(biased) == 110 and len(biased) == 3
    assert [tuple(o.shape[1:3]) for o in outs] == [(19, 19), (38, 38),
                                                   (76, 76)]
    shapes = [tuple(m.conv.weight.shape) for m in convbns]
    want = [s for s, l in zip(R.conv_shapes(CLASSES),
                              [l for l in R.LAYERS if l["type"] == "conv"])
            if l["act"] != "linear"]
    assert shapes == want
    assert net.scale_x_y == R.scale_x_y()


def test_logits_match_the_reference():
    """fp32 to 1e-4 (summation order only); bf16 convs within 0.15 of the
    reference on every layer, where int8 convs (``Int8Act``, a narrower
    product than bf16) land above it.  Measured here: fp32 1-2e-5, bf16
    0.066-0.100, int8 0.195-0.273 (the rounding of 107 stacked convs at a
    4x4 grid)."""
    net = _net()
    x = _images(1)
    want = R.forward(x.permute(0, 3, 1, 2), _weights())
    with torch.no_grad():
        fp32 = _rel_errors(net(x, dtype=torch.float32), want)
        bf16 = _rel_errors(net(x, dtype=torch.bfloat16), want)
        int8 = _rel_errors(net(x, dtype=TL.Int8Act(torch.bfloat16)), want)
    assert max(fp32) < 1e-4, fp32
    assert max(bf16) < 0.15, bf16
    assert max(int8) > 0.15, int8


def _canvases(seed):
    rng = np.random.default_rng(seed)
    hws = np.array([[150, 100], [90, 160], [160, 160]], np.int32)
    canv = np.zeros((3, 160, 160, 3), np.uint8)
    for i, (h, w) in enumerate(hws):
        canv[i, :h, :w] = (rng.random((h, w, 3)) ** 2 * 255).astype(np.uint8)
    return canv, hws


def _match(got, want, box_tol):
    """Every reference detection (class, score, box) has one served
    detection of its class within 1e-5 in score and ``box_tol`` pixels in
    each coordinate, and the counts agree."""
    assert len(got.scores) == len(want)
    left = list(zip(got.classes.tolist(), got.scores.tolist(),
                    got.boxes.tolist()))
    for c, s, box in want:
        hit = next((k for k, (gc, gs, gb) in enumerate(left)
                    if gc == c and abs(gs - s) <= 1e-5
                    and max(abs(a - b) for a, b in zip(gb, box)) <= box_tol),
                   None)
        assert hit is not None, (c, s, box)
        left.pop(hit)


def test_served_detections_match_the_reference_decode_and_nms():
    """``Predictor.predict_batch`` on the CPU in fp32, taking ``scale_x_y``
    from the net, against the reference's forward on the Predictor's own
    letterboxed images, darknet's decode (float64) and a plain greedy NMS.
    The threshold sits in a gap of the reference's scores, so no score
    lies within rounding of it; boxes agree to 0.01 pixel (fp32 decode
    against float64)."""
    spec = _spec()
    pred = Predictor(_net(), None, spec, obj_thresh=0.5, iou_thresh=0.45,
                     max_out=30, device="cpu")
    assert pred.spec.scale_x_y == (1.05, 1.1, 1.2)
    canv, hws = _canvases(3)
    c, h = torch.from_numpy(canv), torch.from_numpy(hws)
    imgs = pred._letterbox_for_stem(c, h, torch.float32).to(torch.float32)
    imgs = imgs / imgs.flatten(1).amax(1).view(-1, 1, 1, 1)
    outs = R.forward(imgs.permute(0, 3, 1, 2), _weights())
    boxes, scores = R.decode(outs, R.anchors(HW), HW, h, CLASSES)
    top = torch.sort(scores.flatten(), descending=True).values[:40]
    gaps = top[:-1] - top[1:]
    gaps[:8] = -1.0
    gap = int(torch.argmax(gaps))
    thresh = float(top[gap] + top[gap + 1]) / 2
    pred.obj_thresh = thresh
    want = R.nms(boxes, scores, thresh, 0.45, 30)
    got = pred.predict_batch(canv, hws)
    assert sum(len(w) for w in want) >= 4
    for g, w in zip(got, want):
        _match(g, w, box_tol=0.01)


def test_a_spec_with_scale_x_y_kept_and_one_without_takes_the_nets():
    net = _net()
    own = _spec((1.0, 1.0, 1.0))
    assert Predictor(net, None, own, device="cpu").spec.scale_x_y == (
        1.0, 1.0, 1.0)
    assert Predictor(net, None, _spec(), device="cpu").spec.scale_x_y == (
        1.05, 1.1, 1.2)
    v1 = build_network("tiny_yolo", HW, 3, CLASSES)
    assert Predictor(v1, None, voc_spec(HW, ((4, 4), (8, 8))),
                     device="cpu").spec.scale_x_y == ()


def test_geometry_and_decode_with_scale_x_y():
    """Rows 6 and 7 carry s and -(s - 1) / 2 a layer; ``_decode``'s centres
    are darknet's ``(i + sigmoid(t) * s - (s - 1) / 2) / w`` in float64
    within fp32 rounding, its sizes unchanged by s."""
    spec = _spec((1.05, 1.1, 1.2))
    geom = TH.candidate_geometry(spec)
    at = 0
    for (h, w), s in zip(GRIDS, (1.05, 1.1, 1.2)):
        n = h * w * 3
        np.testing.assert_array_equal(geom[6, at:at + n], np.float32(s))
        np.testing.assert_array_equal(geom[7, at:at + n],
                                      np.float32(-(s - 1) / 2))
        at += n
    g = torch.Generator().manual_seed(2)
    p = torch.randn((2, at, 5 + CLASSES), generator=g) * 3
    p[:, :, 2:4] /= 3          # boxes under 5 anchors: corners keep the centre
    lbox = torch.tensor([[0.0, 0.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0]] * 2)
    y0, x0, y1, x1, _ = TH._decode(p, torch.from_numpy(geom), lbox,
                                   classes=CLASSES, class_softmax=False)
    g64 = torch.from_numpy(geom).double()
    sig = torch.sigmoid(p.double())
    cx = (g64[0] + sig[:, :, 0] * g64[6] + g64[7]) * g64[2]
    bw = torch.exp(p[:, :, 2].double()) * g64[4]
    torch.testing.assert_close(((x0 + x1) / 2)[:, 0].double(), cx,
                               rtol=0, atol=2e-6)
    torch.testing.assert_close((x1 - x0)[:, 0].double(), bw, rtol=2e-6,
                               atol=2e-6)
    # the two-stage path (``ops/decode.decode_outputs``) decodes alike
    from k210_yolo_framework_tpu_torch.ops.decode import decode_outputs

    preds, at = [], 0
    for h, w in GRIDS:
        n = h * w * 3
        preds.append(p[:, at:at + n].reshape(2, h, w, 3, 5 + CLASSES))
        at += n
    hws = torch.tensor([[100, 128], [128, 90]])
    boxes, _ = decode_outputs(preds, spec, hws)
    lbox = TH.letterbox_inverse_params(hws, HW)
    y0, x0, y1, x1, _ = TH._decode(p, torch.from_numpy(geom), lbox,
                                   classes=CLASSES, class_softmax=False)
    torch.testing.assert_close(boxes, torch.cat([y0, x0, y1, x1], 1)
                               .transpose(1, 2), rtol=1e-5, atol=1e-3)


def test_a_spec_without_scale_x_y_gives_todays_geometry_and_decode():
    """No ``scale_x_y``: rows 6 and 7 are 1 and 0, the hash is the four
    fields', and ``_decode`` is ``(sigmoid + gx) * inv_gw`` bit for bit,
    NaN and +-inf logits included."""
    spec = _spec()
    assert hash(spec) == hash((spec.in_hw, spec.out_hws, spec.class_num,
                               spec.anchors))
    geom = TH.candidate_geometry(spec)
    assert (geom[6] == 1).all() and (geom[7] == 0).all()
    assert spec == dataclasses.replace(spec, scale_x_y=())
    g = torch.Generator().manual_seed(3)
    p = torch.randn((2, geom.shape[1], 5 + CLASSES), generator=g) * 4
    p.view(-1)[:64:3] = torch.tensor([float("nan"), float("inf"),
                                      -float("inf"), 0.0] * 6)[:22]
    gt = torch.from_numpy(geom)
    lbox = TH.letterbox_inverse_params(torch.tensor([[100, 128], [128, 90]]),
                                       HW)
    y0, x0, _, _, _ = TH._decode(p, gt, lbox, classes=CLASSES,
                                 class_softmax=False)
    cx = (torch.sigmoid(p[:, :, 0]) + gt[0]) * gt[2]
    bw = torch.exp(p[:, :, 2]) * gt[4]
    ox, sx, iw = lbox[:, 1:2], lbox[:, 3:4], lbox[:, 5:6]
    want = (((cx - ox) * sx) - (bw * sx) * 0.5) * iw
    assert torch.equal(x0[:, 0].view(torch.int32), want.view(torch.int32))


def test_mish_one_exp_form_is_f_mish_within_a_few_ulps():
    """The kernel's Mish (``csrc/conv_epilogue.cu``: e = exp(x),
    ``x * (e^2 + 2e) / (e^2 + 2e + 2)``, x above 20 passed through) done
    op for op in fp32 against Mish in float64: within 4 fp32 ulps of the
    value (1e-38 absolute below the normals), as close as ``F.mish``."""
    x = torch.cat([torch.linspace(-90, 30, 200001),
                   torch.tensor([-0.0, 0.0, 20.0, 20.0001])])
    e = torch.exp(x)
    n = e * e + 2 * e
    one_exp = torch.where(x <= 20, x * (n / (n + 2)), x)
    x64 = x.double()
    exact = x64 * torch.tanh(F.softplus(x64, threshold=1e9))
    ulp = torch.finfo(torch.float32).eps * exact.abs()
    for got in (one_exp, F.mish(x)):
        err = (got.double() - exact).abs()
        assert bool((err <= 4 * ulp + 1e-38).all()), float(
            (err / (ulp + 1e-38)).max())
    for special, want in ((float("nan"), float("nan")),
                          (float("inf"), float("inf"))):
        t = torch.tensor([special])
        got = TE.conv_epilogue(t.view(1, 1, 1, 1), torch.zeros(1),
                               torch.ones(1), torch.zeros(1), act="mish")
        assert torch.equal(got.view(1).isnan(), torch.tensor([want != want]))


@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
def test_the_mish_epilogue_is_the_layers_eval_path(store):
    """``conv_epilogue(act="mish")`` on the CPU against ``ConvBN``'s
    unfused eval steps: BatchNorm, ``layers.mish`` in place, the residual,
    the store, bit for bit."""
    g = torch.Generator().manual_seed(4)
    x = (torch.randn((2, 16, 5, 7), generator=g) * 8).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    bn = TL.BatchNorm(16).eval()
    with torch.no_grad():
        bn.running_mean.normal_(0.0, 0.5, generator=g)
        bn.running_var.uniform_(0.3, 2.0, generator=g)
        bn.weight.uniform_(0.4, 1.5, generator=g)
    res = torch.randn((2, 16, 5, 7), generator=g)
    for r in (None, res):
        with torch.no_grad():
            t = TL.mish(bn(x))
            want = (t if r is None else t.add_(r)).to(store)
            got = TE.conv_epilogue(x, *bn.eval_terms(), "mish", residual=r,
                                   store=store)
        assert torch.equal(got, want)


def test_eval_forward_through_the_epilogue_is_the_plain_forward():
    """bf16 without gradients, every ConvBN through the epilogue once (72
    Mish, 35 leaky), equals the forward with gradients on bit for bit; the
    ConvBNs that store fp32 are ``part_b`` and the units' 3x3s, whose
    outputs enter a residual sum."""
    net = _net()
    x = _images(2)
    acts, stores = [], {}
    names = {m: n for n, m in net.named_modules() if isinstance(m, TL.ConvBN)}
    real = TL.conv_epilogue

    def spy(*a, **k):
        acts.append(a[4])
        return real(*a, **k)

    hooks = [m.register_forward_hook(
        lambda m, a, out: stores.__setitem__(names[m], out.dtype))
        for m in names]
    TL.conv_epilogue = spy
    try:
        with torch.no_grad():
            fused = net(x, dtype=torch.bfloat16)
    finally:
        TL.conv_epilogue = real
        for hk in hooks:
            hk.remove()
    assert acts.count("mish") == 72 and acts.count("leaky_relu") == 35
    with torch.enable_grad():
        plain = net(x, dtype=torch.bfloat16)
    for f, p in zip(fused, plain):
        assert torch.equal(f.view(torch.int16), p.view(torch.int16))
    wide = {n for n, d in stores.items() if d == torch.float32}
    assert wide == {n for n in names.values()
                    if n.endswith(("part_b.dark_conv_bn",
                                   "_3x3.dark_conv_bn"))}
    assert len(wide) == 5 + 23


def test_spp_is_darknets_three_pools():
    """``layers.spp`` (two and three 5x5 pools in a row) against 5, 9 and
    13 windows each padded with -inf: equal, negative maps included."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn((2, 3, 6, 9), generator=g) - 3
    want = [F.max_pool2d(F.pad(x, (k // 2,) * 4, value=float("-inf")), k, 1)
            for k in (13, 9, 5)]
    assert torch.equal(TL.spp(x), torch.cat(want + [x], 1))


def _one_rank():
    return types.SimpleNamespace(
        dp=1, mp=1, sp=1, model_group=None, space_group=None,
        data_group=None, pixel_group=None, batch_group=lambda rows: None,
        channel_range=lambda c: (0, c), row_range=lambda h: (0, h))


def test_tpsp_and_export_refuse_yolov4_by_name(monkeypatch):
    """A forward on the TP/SP path, the sharded runner on a mesh with a
    model axis, ``export_raw`` and ``export_serving`` raise, naming
    yolov4; the data-parallel runner is not refused."""
    from k210_yolo_framework_tpu_torch import export as EX
    from k210_yolo_framework_tpu_torch.parallel import mesh as PM

    net = _net()
    x = _images(1, b=1)
    with pytest.raises(NotImplementedError, match="yolov4"):
        net(x, shard=_one_rank())
    pred = Predictor(net, None, _spec(), device="cpu")
    monkeypatch.setattr(PM, "data_group", lambda mesh: None)
    monkeypatch.setattr(torch.distributed, "get_world_size",
                        lambda group=None: 1)
    monkeypatch.setattr(PM, "axis_size",
                        lambda mesh, axis: 2 if axis == PM.MODEL_AXIS else 1)
    with pytest.raises(NotImplementedError, match="yolov4.*model or space"):
        pred.make_sharded_runner(object())
    with pytest.raises(NotImplementedError, match="yolov4.*torch.export"):
        EX.export_raw(net, None, 1, device="cpu")
    with pytest.raises(NotImplementedError, match="yolov4.*torch.export"):
        EX.export_serving(pred)
    assert all(not TY.NETWORKS[name].lacks
               for name in ("yolo_mobilev1", "yolo_mobilev2", "tiny_yolo",
                            "yolo"))


def test_training_refuses_a_net_with_scale_x_y():
    """Every train and eval step refuses a spec or a net with
    ``scale_x_y`` (the loss is YOLOv3's): ``make_train_step``'s,
    ``make_fused_train_step``'s (so ``fit``'s), ``make_eval_step``'s and
    ``make_fused_eval_step``'s.  A scale of 1 everywhere passes."""
    from k210_yolo_framework_tpu_torch.config import TrainConfig
    from k210_yolo_framework_tpu_torch.training import train as TT

    class Batch(tuple):
        def to(self, _device):
            return self

    cfg = TrainConfig(batch_size=2)
    v4, v3 = _spec((1.05, 1.1, 1.2)), _spec()
    plain = types.SimpleNamespace(scale_x_y=())
    state = types.SimpleNamespace(net=_net(), optimizer=None, step=0)
    pre = lambda *a, **k: (None, None)  # noqa: E731
    for spec, net in ((v4, plain), (v3, state.net)):
        owner = "the spec" if net is plain else "YoloV4"
        state.net = net
        with pytest.raises(NotImplementedError, match=f"{owner}.*scale_x_y"):
            TT.make_train_step(spec, cfg)(state, None, None)
        with pytest.raises(NotImplementedError, match=f"{owner}.*scale_x_y"):
            TT.make_fused_train_step(spec, cfg, pre)(state, None, [], None,
                                                     None)
        with pytest.raises(NotImplementedError, match=f"{owner}.*scale_x_y"):
            TT.make_eval_step(spec, cfg)(net, None, None, None)
        with pytest.raises(NotImplementedError, match=f"{owner}.*scale_x_y"):
            TT.make_fused_eval_step(spec, cfg, pre)(net, None, None, [],
                                                    None, None)
    with pytest.raises(NotImplementedError, match="YoloV4.*scale_x_y"):
        TT.fit(_net(), v3, cfg, iter([Batch((None, [], None, None))]), None,
               pre, None, 1, 0, device="cpu")
    TT._refuse_scale_x_y(_spec((1.0, 1.0, 1.0)),
                         types.SimpleNamespace(scale_x_y=(1.0, 1.0, 1.0)))


def test_the_nets_spans_once_a_call_inside_serve_net():
    """``net.csp``, ``net.spp`` and ``net.pan`` under a profiler: once
    each a ``predict_batch`` call, inside ``serve.net``, in that order."""
    from torch.profiler import ProfilerActivity, profile

    pred = Predictor(_net(), None, _spec(), obj_thresh=0.9, device="cpu")
    canv, hws = _canvases(4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            pred.predict_batch(canv[:1], hws[:1])
    ev = {}
    for e in prof.events():
        if e.name.startswith("k210."):
            ev.setdefault(e.name[5:], []).append(e.time_range)
    for name in ("net.csp", "net.spp", "net.pan"):
        assert len(ev[name]) == 2, name
    for k in range(2):
        outer = ev["serve.net"][k]
        inner = [ev[n][k] for n in ("net.csp", "net.spp", "net.pan")]
        assert all(outer.start <= r.start and r.end <= outer.end
                   for r in inner)
        assert inner[0].end <= inner[1].start and inner[1].end <= \
            inner[2].start


def test_keras_inference_and_eval_serve_yolov4(tmp_path, monkeypatch,
                                               capsys):
    """Both scripts with ``--model_def yolov4`` and nothing else new: the
    inference table is ``predict_image``'s, keras_eval scores the set.
    (``init_weights`` is skipped: the checkpoint replaces every weight.)"""
    from PIL import Image

    from k210_yolo_framework_tpu_torch.cli import keras_eval as KE
    from k210_yolo_framework_tpu_torch.cli import keras_inference as KI
    from k210_yolo_framework_tpu_torch.training import checkpoint as CK

    (tmp_path / "data").mkdir()
    np.save(tmp_path / "data" / "s_anchor.npy", R.anchors(HW))
    canv, hws = _canvases(5)
    rows = []
    for i, (h, w) in enumerate(hws):
        path = str(tmp_path / "data" / f"img_{i}.png")
        Image.fromarray(canv[i, :h, :w]).save(path)
        rows.append(np.array([path, np.array([[i % CLASSES, 0.5, 0.5, 0.3,
                                               0.4]]), np.array([h, w])],
                             dtype=object))
    np.save(tmp_path / "data" / "s_img_ann.npy", np.array(rows, dtype=object))
    CK.save_npz(str(tmp_path / "w.npz"), _net())
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(TY, "init_weights", lambda net, generator: net)
    net = ["--train_set", "s", "--class_num", str(CLASSES), "--model_def",
           "yolov4", "--image_size", "128", "128", "--output_size", "4", "4",
           "8", "8", "16", "16", "--device", "cpu"]
    img = str(tmp_path / "data" / "img_0.png")
    det = KI.main(KI.parse_args(net + ["--obj_thresh", "0.3", "--output",
                                       str(tmp_path / "o.png"),
                                       str(tmp_path / "w.npz"), img]))
    want = Predictor(_net(), None, _spec(), obj_thresh=0.3,
                     device="cpu").predict_image(canv[0, :150, :100])
    assert len(det.scores) == len(want.scores) > 0
    np.testing.assert_array_equal(det.boxes, want.boxes)
    res = KE.main(KE.parse_args([str(tmp_path / "w.npz")] + net
                                + ["--batch_size", "2"]))
    out = capsys.readouterr().out
    assert "evaluating 3 rows" in out and 0.0 <= res["map"] <= 1.0

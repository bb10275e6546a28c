"""YOLOv4's kernels on the card: the conv epilogue's Mish kernel against its
plain version at the net's own shapes, the head with ``scale_x_y`` at
608x608 on its global path against its plain version, the head at s = 1
unchanged, and the net served through both.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one; the file imports nothing of JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_yolov4.py

Tolerances, each with its reason: Mish is computed with one exp in the
kernel (``(e^2 + 2e) / (e^2 + 2e + 2)``) and as ``tanh(log1p(exp(x)))``
by PyTorch, so an fp32 store agrees within 8 fp32 ulps of the operands'
magnitude and a bf16 store within one bf16 ulp (an fp32 value on either
side of a rounding boundary); every other step is the leaky kernel's,
bit for bit.  The head keeps ``tests/test_torch_cuda.py``'s ``_close``.
"""

import numpy as np
import pytest
import torch

from k210_yolo_framework_tpu_torch.config import YoloSpec
from k210_yolo_framework_tpu_torch.inference import Predictor, folded_logits
from k210_yolo_framework_tpu_torch.models import build_network
from k210_yolo_framework_tpu_torch.models.layers import BatchNorm, ConvBN
from k210_yolo_framework_tpu_torch.ops import conv_epilogue as TE
from k210_yolo_framework_tpu_torch.ops import yolo_head_pallas as TH
from k210_yolo_framework_tpu_torch.ops.nms import finish_winners

pytestmark = pytest.mark.cuda

# the cfg's anchors over 608, coarsest grid first
V4_ANCHORS = np.array([[[142, 110], [192, 243], [459, 401]],
                       [[36, 75], [76, 55], [72, 146]],
                       [[12, 16], [19, 36], [40, 28]]]) / 608.0
V4_SCALE = (1.05, 1.1, 1.2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _spec(side=608, scale_x_y=V4_SCALE):
    return YoloSpec.create((side, side), tuple(
        (side // st, side // st) for st in (32, 16, 8)), 20, V4_ANCHORS,
        scale_x_y)


# YOLOv4's epilogue shapes at B=32, 608x608 (the stem, stage 1's down and
# branches, stage 3's units, stage 5's), channels last; and the scalar
# path (NCHW)
MISH_SHAPES = [((32, 32, 608, 608), torch.channels_last),
               ((32, 64, 304, 304), torch.channels_last),
               ((32, 128, 76, 76), torch.channels_last),
               ((32, 512, 19, 19), torch.channels_last),
               ((3, 20, 19, 19), torch.contiguous_format)]


def _case(shape, fmt, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    b, c, h, w = shape
    x = torch.randn(shape, generator=g, device=dev) * 6
    flat = x.view(-1)
    flat[:8] = torch.tensor([float("nan"), float("inf"), -float("inf"),
                             -0.0, 0.0, 20.0, 20.5, -95.0], device=dev)
    mean = torch.randn(c, generator=g, device=dev) * 0.5
    mul = torch.rand(c, generator=g, device=dev) + 0.5
    bias = torch.randn(c, generator=g, device=dev) * 0.5
    mean[0], mul[0], bias[0] = 0.0, 1.0, 0.0
    res = torch.randn(shape, generator=g, device=dev)
    scale = torch.rand(b, generator=g, device=dev) + 0.5
    return (x.to(torch.bfloat16).contiguous(memory_format=fmt), mean, mul,
            bias, scale, res.contiguous(memory_format=fmt))


@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
def test_mish_epilogue_matches_plain_at_yolov4_shapes(dev, store):
    """One launch a call, x's strides kept; NaN where the plain version
    has NaN; values within the module docstring's tolerance, with and
    without the scale and the residual."""
    eps = torch.finfo(torch.bfloat16).eps
    for k, (shape, fmt) in enumerate(MISH_SHAPES):
        x, mean, mul, bias, scale, res = _case(shape, fmt, dev, k)
        for s, r in ((None, None), (scale, None), (None, res)):
            kw = dict(act="mish", scale=s, residual=r, store=store)
            before = TE.conv_epilogue.launches
            got = TE.conv_epilogue(x, mean, mul, bias, **kw)
            assert TE.conv_epilogue.launches == before + 1
            want = TE.conv_epilogue_reference(x, mean, mul, bias, **kw)
            core = TE.conv_epilogue_reference(x, mean, mul, bias, act="mish",
                                              scale=s).abs()
            assert got.stride() == x.stride() and got.dtype == store
            assert torch.equal(got.isnan(), want.isnan())
            ok = ~want.isnan()
            size = core + (0 if r is None else r.abs())
            tol = 8 * torch.finfo(torch.float32).eps * size + 1e-37
            if store == torch.bfloat16:
                tol = tol + eps * want.float().abs()
            # equal infinities differ by NaN: count them as equal
            err = torch.where(got == want, 0.0,
                              (got.float() - want.float()).abs())
            assert bool((err[ok] <= tol[ok]).all()), (shape, s is None,
                                                      r is None)
            if store == torch.bfloat16:
                assert float((got != want)[ok].float().mean()) < 0.01
            del got, want, core, err, tol


def test_the_mish_kernel_is_named_in_the_trace(dev):
    """The device trace names the Mish instantiation, and a leaky launch
    stays on the other kernel."""
    from torch.profiler import ProfilerActivity, profile

    x, mean, mul, bias, _, _ = _case((2, 64, 38, 38), torch.channels_last,
                                     dev, 9)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        TE.conv_epilogue(x, mean, mul, bias, act="mish", store=x.dtype)
        TE.conv_epilogue(x, mean, mul, bias, act="leaky_relu", alpha=0.1,
                         store=x.dtype)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if "epilogue" in e.name]
    assert sum("epilogue_mish_kernel" in n for n in names) == 1
    assert sum("epilogue_kernel" in n for n in names) == 1


def _close(got, want, thresh):
    """``tests/test_torch_cuda.py``'s head tolerance: ``valid`` may flip
    only within 1e-5 of the threshold; classes equal; scores 2e-5, boxes
    1e-3 relative (fp32 transcendental functions of two libraries)."""
    g = [t.cpu().numpy() for t in got]
    w = [t.cpu().numpy() for t in want]
    flip = g[3] != w[3]
    near = np.abs(np.where(g[3], g[1], w[1])[flip] - thresh)
    assert (near <= 1e-5).all(), f"{int(flip.sum())} valid flips"
    both = g[3] & w[3]
    np.testing.assert_array_equal(g[2], w[2])
    np.testing.assert_allclose(g[1][both], w[1][both], rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(g[0][both], w[0][both], rtol=1e-3, atol=0.05)


def _preds(spec, bsz, seed):
    rng = np.random.default_rng(seed)
    out = []
    for h, w in spec.out_hws:
        p = rng.normal(0, 2, (bsz, h, w, spec.nanchors, 5 + spec.class_num))
        p[..., 4:] += 1.5
        out.append(torch.from_numpy(p.astype(np.float32)))
    return out


def _winners(spec, preds, hws, dev, plain):
    lbox = TH.letterbox_inverse_params(hws, spec.in_hw).contiguous()
    p = TH._flatten_preds(preds, spec.class_num)
    geom = TH._geometry_on(spec, dev)
    kw = dict(classes=20, max_out=100, iou_thresh=0.45)
    if plain:
        w_s, *w_box = TH._decode_and_select(p, geom, lbox, class_softmax=False,
                                            stop_below=0.01, **kw)
        return finish_winners(w_s, torch.stack(w_box, dim=-1), 0.01)
    return finish_winners(*TH._launch(p, geom, lbox, score_thresh=0.01,
                                      class_softmax=False, **kw), 0.01)


def test_head_with_scale_x_y_on_the_global_path(dev):
    """N = 22,743 at B = 4 (the global path) with YOLOv4's scale_x_y, eval
    settings (0.01, NMS 0.45, 100 a class), in score order: the kernel
    against its plain version on the card, bit for bit (both decode ``(sigmoid(t) * s +
    shift + gx) * inv_gw`` in that order, with no fused multiply-add); the
    same logits at s = 1 give other boxes."""
    spec = _spec()
    preds = [p.to(dev) for p in _preds(spec, 4, 1)]
    hws = torch.tensor([[375, 500], [500, 375], [333, 500], [500, 333]],
                       dtype=torch.int32, device=dev)
    n = sum(h * w for h, w in spec.out_hws) * 3
    assert n == 22_743 and TH._plan(dev, 4, n, 20)[0] == "global"
    before = (TH.fused_decode_nms.global_launches,
              TH.fused_decode_nms.ordered_launches)
    got = _winners(spec, preds, hws, dev, plain=False)
    torch.cuda.synchronize()
    assert TH.fused_decode_nms.global_launches == before[0] + 1
    assert TH.fused_decode_nms.ordered_launches == before[1] + 1
    want = _winners(spec, preds, hws, dev, plain=True)
    _close(got, want, 0.01)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    one = _winners(_spec(scale_x_y=()), preds, hws, dev, plain=False)
    assert not torch.equal(one.boxes, got.boxes)


@pytest.mark.parametrize("side", [608, 224])
def test_head_at_scale_one_is_unchanged(dev, side):
    """A spec with scale_x_y (1, 1, 1) and one without give the kernel the
    same geometry, so the same winners bit for bit, on the global path
    (608) and in shared memory (224)."""
    ones = _spec(side, (1.0, 1.0, 1.0))
    plain = _spec(side, ())
    assert torch.equal(TH._geometry_on(ones, dev), TH._geometry_on(plain,
                                                                   dev))
    preds = [p.to(dev) for p in _preds(plain, 4, 2)]
    hws = torch.tensor([[375, 500]] * 4, dtype=torch.int32, device=dev)
    a = _winners(ones, preds, hws, dev, plain=False)
    b = _winners(plain, preds, hws, dev, plain=False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_yolov4_served_through_both_kernels(dev):
    """YOLOv4 at 256x256 served in bf16: 107 epilogue launches a call (72
    on the Mish kernel), one head launch; its logits against the same
    forward with gradients on (every ConvBN unfused, ``F.mish``) within
    2% of their spread (bf16 stores of values the two Mish forms round
    apart, carried through the net)."""
    spec = _spec(256)
    net = build_network("yolov4", spec.in_hw, 3, 20,
                        generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(0.0, 0.3, generator=g)
                m.running_var.uniform_(0.3, 2.0, generator=g)
                m.weight.uniform_(0.4, 0.6, generator=g)
                m.bias.normal_(0.3, 0.3, generator=g)
    n = sum(isinstance(m, ConvBN) for m in net.modules())
    assert n == 107
    pred = Predictor(net, None, spec, obj_thresh=0.3,
                     compute_dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(4)
    canvases = rng.integers(0, 256, (4, 320, 320, 3)).astype(np.uint8)
    hws = np.array([[320, 320], [300, 200], [160, 320], [320, 100]], np.int32)
    before = (TE.conv_epilogue.launches, TH.fused_decode_nms.launches)
    pred.predict_batch(canvases, hws)
    assert TE.conv_epilogue.launches == before[0] + n
    assert TH.fused_decode_nms.launches == before[1] + 1
    c, h = torch.from_numpy(canvases).to(dev), torch.from_numpy(hws).to(dev)
    fused = pred._forward_batch(c, h)
    imgs = pred._letterbox_for_stem(c, h, pred.compute_dtype)
    with torch.enable_grad():
        plain = folded_logits(pred.net, pred._materialize(), imgs,
                              pred.module_dtype)
    for f, p in zip(fused, plain):
        err = float((f.float() - p.float()).norm() / p.float().norm())
        assert err < 0.02, err

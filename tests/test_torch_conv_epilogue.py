"""The conv epilogue (``ops/conv_epilogue.py``) on the CPU, where the wrapper
takes its plain version: that version equals the layers' own eval path
(``BatchNorm.forward``, the activation, ``residual_add``, the cast) bit for
bit; every builder's eval forward through it equals the same forward with
gradients on, where each ConvBN runs those steps as their own passes; the
ConvBNs that store in the compute dtype are the ones whose consumers all
cast to it, and a residual stored in the compute dtype is refused; and
training, the TP/SP path, a witness with smooth activations and
``torch.export`` never take it.  The kernel itself is held
to the plain version in ``tests/test_torch_cuda.py``.
"""

import functools
import types

import pytest
import torch

from k210_yolo_framework_tpu_torch.models import build_network
from k210_yolo_framework_tpu_torch.models import layers as TL
from k210_yolo_framework_tpu_torch.ops import conv_epilogue as TE

torch.set_num_threads(1)

SPECIAL = [float("nan"), float("inf"), -float("inf"), -0.0, 0.0, 6.0, -1e-40]

ACT_FNS = {"none": None, "relu": TL.relu, "relu6": TL.relu6,
           "leaky_relu": TL.leaky_relu(0.1), "mish": TL.mish}


def _bits(t):
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def _case(dtype, seed=0):
    """A channels-last conv output [2, 12, 5, 7] with specials planted, an
    eval BatchNorm whose channel 0 is the identity with a -0 shift, a
    residual and a per-image scale."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((2, 12, 5, 7), generator=g) * 3
    x[:, 0] = torch.tensor(SPECIAL * 5)[:35].view(5, 7)
    x.view(-1)[torch.randint(0, x.numel(), (20,), generator=g)] = \
        torch.tensor(SPECIAL * 3)[:20]
    bn = TL.BatchNorm(12).eval()
    with torch.no_grad():
        bn.running_mean.normal_(0.0, 0.5, generator=g)
        bn.running_var.uniform_(0.3, 2.0, generator=g)
        bn.weight.uniform_(0.4, 1.5, generator=g)
        bn.bias.normal_(0.0, 0.5, generator=g)
        bn.running_mean[0], bn.running_var[0] = 0.0, 1.0 - 1e-3
        bn.weight[0], bn.bias[0] = 1.0, -0.0
    res = torch.randn((2, 12, 5, 7), generator=g)
    res[1, 3] = torch.tensor(SPECIAL * 5)[:35].view(5, 7)
    scale = torch.rand(2, generator=g) + 0.5
    cl = torch.channels_last
    return (x.to(dtype).contiguous(memory_format=cl), bn, scale,
            res.contiguous(memory_format=cl))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("act", TE.ACTS)
def test_plain_epilogue_is_the_layers_eval_path(act, with_residual,
                                                with_scale, narrow, dtype):
    """``conv_epilogue`` on the CPU against ConvBN's unfused eval steps
    without gradients: the scale cast to the conv's dtype, ``BatchNorm``,
    the activation in place, ``residual_add`` into the fresh output, the
    cast to the store; NaN, +-inf, -0, 6.0 and a denormal included."""
    x, bn, scale, res = _case(dtype)
    store = dtype if narrow else torch.float32
    s = scale if with_scale else None
    r = res if with_residual else None
    fn = ACT_FNS[act]
    with torch.no_grad():
        t = x if s is None else x * s.to(x.dtype)[:, None, None, None]
        t = bn(t)
        if fn is not None:
            t = fn(t)
        if r is not None:
            t = TL.residual_add(t, r)
        want = t.to(store)
        alpha = 0.1 if act == "leaky_relu" else 0.0
        got = TE.conv_epilogue(x, *bn.eval_terms(), act, alpha, scale=s,
                               residual=r, store=store)
    assert got.dtype == store and got.shape == x.shape
    assert torch.equal(_bits(got), _bits(want))


@functools.cache
def _net(name):
    """A small builder with drawn BN statistics and affine terms, in eval
    mode without gradients (cached: darknet53 takes seconds to build)."""
    alpha, hw = (0.75, (64, 96)) if name.startswith("yolo_mobile") else (
        1.0, (64, 64))
    net = build_network(name, hw, 3, 20, alpha=alpha,
                        generator=torch.Generator().manual_seed(0)).eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, TL.BatchNorm):
                m.running_mean.normal_(0.0, 0.3, generator=g)
                m.running_var.uniform_(0.3, 2.0, generator=g)
                m.weight.uniform_(0.4, 0.6, generator=g)
                m.bias.normal_(0.3, 0.3, generator=g)
    x = torch.randint(0, 256, (2, *hw, 3), generator=g).to(torch.uint8)
    return net.requires_grad_(False), x


def _wide_convbns(name, net):
    """The ConvBNs whose eval output must stay fp32: it enters a later
    fp32 residual sum (darknet53's ``down`` convs and unit sums;
    MobileNetV2's blocks before a residual block, the stem included)."""
    if name == "yolo":
        return {n for n, m in net.named_modules()
                if isinstance(m, TL.ConvBN)
                and (".down." in n or n.endswith("_3x3.dark_conv_bn"))}
    if name == "yolo_mobilev2":
        body = net.backbone
        wide = {"backbone.stem"} if body.block_0.residual else set()
        for i in range(16):
            if getattr(body, f"block_{i + 1}").residual:
                wide.add(f"backbone.block_{i}.project")
        return wide
    return set()


DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
          "int8_act": TL.Int8Act(torch.bfloat16)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ["yolo_mobilev1", "yolo_mobilev2",
                                  "tiny_yolo", "yolo"])
def test_builder_eval_forward_on_cpu_is_unchanged(name, dtype, monkeypatch):
    """The eval forward without gradients, every ConvBN through the
    epilogue once, equals the same forward with gradients on (every
    ConvBN unfused) bit for bit, the stem's per-image scale included; the
    ConvBNs that store fp32 are those whose output enters a later fp32 sum
    (all of them under Int8Act), the rest the compute dtype."""
    net, x = _net(name)
    dt = DTYPES[dtype]
    scale = torch.tensor([1 / 255.0, 1 / 199.0])
    convbns = {m: n for n, m in net.named_modules()
               if isinstance(m, TL.ConvBN)}
    calls, stores = [], {}
    real = TL.conv_epilogue
    monkeypatch.setattr(TL, "conv_epilogue",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    hooks = [m.register_forward_hook(
        lambda m, a, out: stores.__setitem__(convbns[m], out.dtype))
        for m in convbns]
    try:
        with torch.no_grad():
            fused = net(x, input_scale=scale, dtype=dt)
    finally:
        for h in hooks:
            h.remove()
    assert len(calls) == len(convbns)
    with torch.enable_grad():
        plain = net(x, input_scale=scale, dtype=dt)
    assert len(calls) == len(convbns)
    for f, p in zip(fused, plain):
        assert f.dtype == p.dtype and torch.equal(_bits(f), _bits(p))
    wide = _wide_convbns(name, net) if dtype == "bf16" \
        else set(convbns.values())
    assert {n for n, d in stores.items() if d == torch.float32} == wide
    assert set(stores) == set(convbns.values())


@pytest.mark.parametrize("name", ["yolo", "yolo_mobilev2", "yolov4",
                                  "convbn"])
def test_a_skip_stored_narrow_is_refused(name):
    """A residual sum whose skip was stored in bf16 would lose bits in the
    sum: with one ``wide`` mark cleared on a builder (its first, an addend
    of the first residual sum), the bf16 eval forward without gradients
    raises; a lone ConvBN refuses a bf16 residual and takes an fp32 one."""
    with torch.no_grad():
        if name == "convbn":
            conv = TL.ConvBN(4, 4, act=TL.leaky_relu(0.1)).eval()
            x = torch.rand((1, 4, 6, 6))
            with pytest.raises(ValueError, match="lacks wide=True"):
                conv(x, torch.bfloat16, residual=x.bfloat16())
            y = conv(x, torch.bfloat16, residual=x)
            assert y.dtype == torch.bfloat16 and y.shape == x.shape
            return
        net, x = _net(name)
        first = next(m for m in net.modules()
                     if isinstance(m, TL.ConvBN) and m.wide)
        first.wide = False
        try:
            with pytest.raises(ValueError, match="lacks wide=True"):
                net(x, dtype=torch.bfloat16)
        finally:
            first.wide = True


def _one_rank():
    """A TP/SP context of one rank: every channel and row its own."""
    return types.SimpleNamespace(
        dp=1, mp=1, sp=1, model_group=None, space_group=None,
        data_group=None, pixel_group=None, batch_group=lambda rows: None,
        channel_range=lambda c: (0, c), row_range=lambda h: (0, h))


@pytest.mark.parametrize("where", ["eval", "train", "grad", "smooth",
                                   "sharded", "export"])
def test_epilogue_engages_in_eval_without_gradients_only(where, monkeypatch):
    """yolo_mobilev1 alpha 0.75: every one of its 30 ConvBNs takes the
    epilogue in eval mode without gradients; none in train mode, with
    gradients on, on the smooth witness, on the TP/SP path or under
    ``torch.export``."""
    net = build_network("yolo_mobilev1", (64, 96), 3, 20, alpha=0.75,
                        generator=torch.Generator().manual_seed(0))
    net = (TL.smooth_witness(net) if where == "smooth" else net).eval()
    x = torch.rand((1, 64, 96, 3))
    calls = []
    real = TL.conv_epilogue
    monkeypatch.setattr(TL, "conv_epilogue",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    if where == "export":
        torch.export.export(net.requires_grad_(False), (x,))
    elif where == "grad":
        net(x)
    else:
        if where == "train":
            net.train()
        with torch.no_grad():
            net(x, shard=_one_rank() if where == "sharded" else None)
    assert len(calls) == (30 if where == "eval" else 0)

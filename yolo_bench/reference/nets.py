"""The detectors in plain fp32 PyTorch: yolo_mobilev1 (the K210
framework's MobileNetV1 variant under the two-scale head) and YOLOv3
(darknet53 under the three-scale head) here, and any other net in a
builder file of its own, ``builders/<model_def>.py`` (:func:`build`).

Written from the published descriptions (the K210 framework's
``mobilenet_v1.py`` / ``yolo.py`` and ``cfg/yolov3.cfg``), not from the
program: every layer is a conv, a BatchNorm and an activation written out
here.  Parameter names follow the weight layout the benchmark makes
(``<scope>.conv.weight``, ``<scope>.bn.weight`` ...), which is the layout of
the program's state dict, so one made state dict serves both.

Departures from the program's arithmetic, each giving the same function:

* the program folds each image's ``1 / max`` in after the stem conv; here
  the image is divided by its max first (a conv without bias is linear);
* BatchNorm computes ``(x - mean) / sqrt(var + eps) * gamma + beta`` in that
  order, and a batch's variance as ``x.var(unbiased=False)``;
* every conv runs in fp32 with TF32 off (``ensure_fp32``).

``Rounding`` puts a lower precision under every conv (its input and its
kernel), which the benchmark's control uses; the default rounds nothing.
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3

Pads = Tuple[int, int, int, int]   # F.pad order: left, right, top, bottom


def ensure_fp32() -> None:
    """Plain fp32 products: no TF32 in matmuls or cuDNN convs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Rounding:
    """What a conv's input and kernel pass through before the product:
    nothing by default."""

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return t


class FP8Rounding(Rounding):
    """float8 e4m3 with one scale a tensor (its largest magnitude onto
    448), the rounding of an fp8 conv; its gradient passes straight
    through."""

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        amax = t.detach().abs().amax().clamp_min(1e-12)
        scale = 448.0 / amax
        q = (t.detach() * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
        return t + (q - t).detach()


class Ctx:
    """How one forward runs: ``bn`` is ``"eval"`` (running statistics),
    ``"train"`` (the batch's) or ``"calibrate"`` (the batch's, also stored
    as the running ones); ``rounding`` is applied under every conv."""

    def __init__(self, bn: str = "eval", rounding: Optional[Rounding] = None):
        self.bn = bn
        self.rounding = rounding or Rounding()


def leaky(alpha: float) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda x: torch.where(x >= 0, x, alpha * x)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0.0)


class Conv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 pads: Pads = (0, 0, 0, 0), groups: int = 1,
                 bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride, self.pads, self.groups = stride, pads, groups

    def forward(self, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        x = F.pad(ctx.rounding(x), self.pads)
        return F.conv2d(x, ctx.rounding(self.weight), self.bias, self.stride,
                        0, 1, self.groups)


class BN(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer("running_mean", torch.empty(c))
        self.register_buffer("running_var", torch.empty(c))

    def forward(self, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        if ctx.bn == "eval":
            mean, var = self.running_mean, self.running_var
        else:
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            if ctx.bn == "calibrate":
                self.running_mean.copy_(mean.detach())
                self.running_var.copy_(var.detach())
        c = (1, -1, 1, 1)
        return ((x - mean.view(c)) / torch.sqrt(var.view(c) + BN_EPS)
                * self.weight.view(c) + self.bias.view(c))


class ConvBN(nn.Module):
    """conv (no bias) -> BN -> activation; names ``conv.*`` and ``bn.*``."""

    def __init__(self, cin, cout, k, stride=1, pads=None, depthwise=False,
                 act=None):
        super().__init__()
        if pads is None:           # stride 1: SAME, the odd pixel after
            lo = (k - 1) // 2
            pads = (lo, k - 1 - lo, lo, k - 1 - lo)
        self.conv = Conv(cin, cin if depthwise else cout, k, stride, pads,
                         groups=cin if depthwise else 1)
        self.bn = BN(cin if depthwise else cout)
        self.act = act

    def forward(self, x, ctx):
        y = self.bn(self.conv(x, ctx), ctx)
        return y if self.act is None else self.act(y)


class DarkConv(nn.Module):
    """darknet's conv + BN + LeakyReLU(0.1), scope ``dark_conv_bn``; a
    stride-2 one pads the top and left by one pixel only."""

    def __init__(self, cin, cout, k, stride=1):
        super().__init__()
        pads = (1, 0, 1, 0) if stride == 2 else None
        self.dark_conv_bn = ConvBN(cin, cout, k, stride, pads,
                                   act=leaky(0.1))

    def forward(self, x, ctx):
        return self.dark_conv_bn(x, ctx)


class HeadConv(nn.Module):
    """The 1x1 output conv with bias, scope ``dark_conv_out``."""

    def __init__(self, cin, cout):
        super().__init__()
        self.dark_conv_out = Conv(cin, cout, 1, bias=True)

    def forward(self, x, ctx):
        return self.dark_conv_out(x, ctx)


def up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


# ---- yolo_mobilev1 ---------------------------------------------------------

# (pointwise filters before alpha, stride) of blocks 2..13
_V1_BLOCKS = ((128, 2), (128, 1), (256, 2), (256, 1), (512, 2), (512, 1),
              (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1))


class _DW(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.dw = ConvBN(cin, cin, 3, stride, (1, 1, 1, 1), depthwise=True,
                         act=relu)
        self.pw = ConvBN(cin, cout, 1, act=leaky(0.3))

    def forward(self, x, ctx):
        return self.pw(self.dw(x, ctx), ctx)


class _MobileV1Body(nn.Module):
    def __init__(self, alpha):
        super().__init__()
        c = int(32 * alpha)
        self.stem = ConvBN(3, c, 3, 2, (1, 1, 1, 1), act=leaky(0.3))
        c1 = int((40 if alpha == 1.0 else 64) * alpha)
        self.block_1 = _DW(c, c1, 1)
        c = c1
        for i, (f, s) in enumerate(_V1_BLOCKS, start=2):
            setattr(self, f"block_{i}", _DW(c, int(f * alpha), s))
            c = int(f * alpha)
        self.tap_c, self.out_c = int(512 * alpha), c

    def forward(self, x, ctx):
        x = self.block_1(self.stem(x, ctx), ctx)
        tap = None
        for i in range(2, 2 + len(_V1_BLOCKS)):
            x = getattr(self, f"block_{i}")(x, ctx)
            if i == 11:
                tap = x
        return tap, x


class _TwoScaleHead(nn.Module):
    def __init__(self, tap_c, trunk_c, out_c, y1_c, y2_c):
        super().__init__()
        self.y1_conv = DarkConv(trunk_c, y1_c, 3)
        self.y1_out = HeadConv(y1_c, out_c)
        self.up_conv = DarkConv(trunk_c, 128, 1)
        self.y2_conv = DarkConv(128 + tap_c, y2_c, 3)
        self.y2_out = HeadConv(y2_c, out_c)

    def forward(self, tap, trunk, ctx):
        y1 = self.y1_out(self.y1_conv(trunk, ctx), ctx)
        x = torch.cat([up2(self.up_conv(trunk, ctx)), tap], dim=1)
        return [y1, self.y2_out(self.y2_conv(x, ctx), ctx)]


class YoloMobileV1(nn.Module):
    def __init__(self, anchors: int, classes: int, alpha: float):
        super().__init__()
        self.backbone = _MobileV1Body(alpha)
        self.head = _TwoScaleHead(self.backbone.tap_c, self.backbone.out_c,
                                  anchors * (5 + classes),
                                  128 if alpha > 0.8 else 192, 128)

    def heads(self, x, ctx):
        return self.head(*self.backbone(x, ctx), ctx)


# ---- YOLOv3 on darknet53 ---------------------------------------------------

_D53_STAGES = ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4))


class _Stage(nn.Module):
    def __init__(self, cin, f, n):
        super().__init__()
        self.down = DarkConv(cin, f, 3, 2)
        for i in range(n):
            setattr(self, f"res_{i}_1x1", DarkConv(f, f // 2, 1))
            setattr(self, f"res_{i}_3x3", DarkConv(f // 2, f, 3))
        self.n = n

    def forward(self, x, ctx):
        x = self.down(x, ctx)
        for i in range(self.n):
            y = getattr(self, f"res_{i}_1x1")(x, ctx)
            x = x + getattr(self, f"res_{i}_3x3")(y, ctx)
        return x


class _Darknet53(nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = DarkConv(3, 32, 3)
        c = 32
        for i, (f, n) in enumerate(_D53_STAGES, start=1):
            setattr(self, f"stage_{i}", _Stage(c, f, n))
            c = f

    def forward(self, x, ctx):
        x = self.stage_2(self.stage_1(self.stem(x, ctx), ctx), ctx)
        t8 = self.stage_3(x, ctx)
        t16 = self.stage_4(t8, ctx)
        return t8, t16, self.stage_5(t16, ctx)


class _Last(nn.Module):
    """Five 1x1 / 3x3 trunk convs and a 3x3 branch to the head."""

    def __init__(self, cin, f):
        super().__init__()
        for i, (c, k) in enumerate(((f, 1), (2 * f, 3), (f, 1), (2 * f, 3),
                                    (f, 1))):
            setattr(self, f"trunk_{i}", DarkConv(cin, c, k))
            cin = c
        self.branch = DarkConv(f, 2 * f, 3)

    def forward(self, x, ctx):
        for i in range(5):
            x = getattr(self, f"trunk_{i}")(x, ctx)
        return x, self.branch(x, ctx)


class YoloV3(nn.Module):
    def __init__(self, anchors: int, classes: int, alpha: float = 1.0):
        super().__init__()
        out = anchors * (5 + classes)
        self.backbone = _Darknet53()
        self.last_512 = _Last(1024, 512)
        self.y1_out = HeadConv(1024, out)
        self.up1_conv = DarkConv(512, 256, 1)
        self.last_256 = _Last(256 + 512, 256)
        self.y2_out = HeadConv(512, out)
        self.up2_conv = DarkConv(256, 128, 1)
        self.last_128 = _Last(128 + 256, 128)
        self.y3_out = HeadConv(256, out)

    def heads(self, x, ctx):
        t8, t16, t32 = self.backbone(x, ctx)
        x, y = self.last_512(t32, ctx)
        y1 = self.y1_out(y, ctx)
        x, y = self.last_256(torch.cat([up2(self.up1_conv(x, ctx)), t16], 1),
                             ctx)
        y2 = self.y2_out(y, ctx)
        _, y = self.last_128(torch.cat([up2(self.up2_conv(x, ctx)), t8], 1),
                             ctx)
        return [y1, y2, self.y3_out(y, ctx)]


BUILDERS = {"yolo_mobilev1": YoloMobileV1, "yolo": YoloV3}
BUILDER_DIR = Path(__file__).resolve().parent / "builders"


def builder_file(model_def: str) -> Optional[ModuleType]:
    """``builders/<model_def>.py``, loaded by path, for a net that is not in
    ``BUILDERS``; None for one that is.

    The file defines ``Net(anchors, classes, alpha)``, a module made of
    this file's ``Conv``, ``BN`` and ``HeadConv`` (``ConvBN``, ``DarkConv``
    and the like are made of them) whose ``heads(x, ctx)`` takes NCHW
    images and returns each output layer's raw logits, layer 0 the
    coarsest grid.  Its output convs are the only convs with a bias, and
    they are registered in output order (``weights.calibrate`` pairs them
    with the outputs so).  It may define ``decode(logits, anchors, in_hw,
    img_hws)`` where its decode is not ``serve.decode``'s, with the same
    outputs in the same candidate order (layer, row, column, anchor); the
    net's own constants (a ``scale_x_y``) live in the file."""
    if model_def in BUILDERS:
        return None
    return _load_builder(BUILDER_DIR / f"{model_def}.py", model_def)


@functools.lru_cache(maxsize=None)
def _load_builder(path: Path, model_def: str) -> ModuleType:
    """A builder file, loaded once a process: every caller of one
    ``model_def`` gets the same module, and so the same ``Net`` class."""
    if not path.is_file():
        raise KeyError(f"unknown model_def {model_def!r}: not in "
                       f"reference.nets.BUILDERS {sorted(BUILDERS)} and no "
                       f"builder file {path}")
    spec = importlib.util.spec_from_file_location(
        "yolo_bench_builder_" + model_def.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(model_def: str, anchors: int, classes: int,
          alpha: float = 1.0) -> nn.Module:
    """The reference net of ``model_def``, its tensors uninitialised:
    ``BUILDERS``' class, or the ``Net`` of its builder file
    (:func:`builder_file`)."""
    mod = builder_file(model_def)
    return (BUILDERS[model_def] if mod is None else mod.Net)(anchors, classes,
                                                            alpha)


def forward(net: nn.Module, images: torch.Tensor, anchors: int,
            ctx: Optional[Ctx] = None) -> List[torch.Tensor]:
    """images [B, H, W, 3] with values in [0, 1] (each image already divided
    by its max) -> per layer [B, h, w, anchors, 5 + C] fp32 logits."""
    ctx = ctx or Ctx()
    outs = net.heads(images.to(torch.float32).permute(0, 3, 1, 2), ctx)
    return [o.permute(0, 2, 3, 1).reshape(o.shape[0], o.shape[2], o.shape[3],
                                           anchors, -1) for o in outs]


def conv_layers(net: nn.Module) -> List[Tuple[str, Conv]]:
    return [(n, m) for n, m in net.named_modules() if isinstance(m, Conv)]


def bn_layers(net: nn.Module) -> List[Tuple[str, BN]]:
    return [(n, m) for n, m in net.named_modules() if isinstance(m, BN)]


def tensors(net: nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter and statistic by name (the made state dict's
    keys)."""
    return dict(net.state_dict(keep_vars=True))


"""YOLO network builders.

Counterpart of ``k210_yolo_framework_tpu/models/yolonet.py``.  A built net
takes NHWC images and returns, per output layer (layer 0 = coarsest grid =
biggest anchors), the raw head outputs ``[B, h, w, a * (5 + C)]``
(``forward_raw``) or their ``[B, h, w, a, 5 + C]`` view (``forward``), in
the compute ``dtype``.  ``net.train()`` is the JAX package's
``apply(..., train=True)``: BatchNorm on batch statistics, running
statistics updated in place; ``net.eval()`` serves.

All four builders of the JAX package: ``yolo_mobilev1``, ``yolo_mobilev2``
and ``tiny_yolo`` (two scales) and the darknet53 ``yolo`` (three); and one
the JAX package lacks, ``yolov4`` (CSPDarknet53, SPP, PANet; three scales
with darknet's ``scale_x_y``, which the head decodes with).

``shard`` (a ``parallel.sharded.ShardContext``) runs this rank's part of
the forward on a mesh with a model or space axis: the image enters whole,
each layer computes its channels and rows (``parallel/sharded.py``), and
the head outputs are gathered, so every rank returns them whole.
The four builders of the JAX package take it; ``yolov4`` refuses it, and
``torch.export`` (``YoloNet.require``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from k210_yolo_framework_tpu_torch.models.cspdarknet import (
    ConvStack,
    CSPDarknet53,
)
from k210_yolo_framework_tpu_torch.models.darknet import (
    Darknet53,
    LastLayers,
    TinyYoloBody,
)
from k210_yolo_framework_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    DarknetConvBN,
    cat_channels,
    darknet_head_conv,
    spp,
    upsample2x,
)
from k210_yolo_framework_tpu_torch.models.mobilenet_v1 import MobileNetV1
from k210_yolo_framework_tpu_torch.models.mobilenet_v2 import MobileNetV2
from k210_yolo_framework_tpu_torch.parallel.sharded import Sharded
from k210_yolo_framework_tpu_torch.utils.trace import span

__all__ = ["YoloNet", "YoloMobileV1", "YoloMobileV2", "TinyYolo", "Yolo",
           "YoloV4", "build_network", "init_weights", "NETWORKS"]


class _TwoScaleHead(nn.Module):
    """2-scale head of the mobilenet/tiny builders: y1 from the stride-32
    trunk; y2 from [upsample(trunk 1x1-128), stride-16 tap] (that order)."""

    def __init__(self, tap_channels: int, trunk_channels: int,
                 out_channels: int, y1_filters: int, y2_filters: int):
        super().__init__()
        self.y1_conv = DarknetConvBN(trunk_channels, y1_filters, (3, 3))
        self.y1_out = darknet_head_conv(y1_filters, out_channels)
        self.up_conv = DarknetConvBN(trunk_channels, 128, (1, 1))
        self.y2_conv = DarknetConvBN(128 + tap_channels, y2_filters, (3, 3))
        self.y2_out = darknet_head_conv(y2_filters, out_channels)

    def forward(self, tap16: torch.Tensor, trunk32: torch.Tensor,
                dtype: torch.dtype) -> List[torch.Tensor]:
        y1 = self.y1_out(self.y1_conv(trunk32, dtype, narrow=True), dtype)
        x = upsample2x(self.up_conv(trunk32, dtype, narrow=True))
        x = cat_channels([x, tap16])
        y2 = self.y2_out(self.y2_conv(x, dtype, narrow=True), dtype)
        return [y1, y2]


class YoloNet(nn.Module):
    """A built detector: NHWC images in, per-layer head outputs out.  Each
    builder takes ``stem_mode`` (``layers.ConvBN.stem_mode``, default
    ``"default"``) for its stem; ``net.stem_mode`` reads and sets it."""

    n_out_layers = 2
    # darknet's per-layer decode scale (``config.YoloSpec.scale_x_y``):
    # empty, 1 on every layer
    scale_x_y: tuple = ()
    # paths a builder has not (:meth:`require`): "tpsp", "export"
    lacks: frozenset = frozenset()

    def __init__(self, anchor_num: int, class_num: int,
                 in_hw: Sequence[int]):
        super().__init__()
        self.anchor_num = anchor_num
        self.class_num = class_num
        self.in_hw = tuple(in_hw)

    def _heads(self, x: torch.Tensor, dtype: torch.dtype,
               input_scale: Optional[torch.Tensor]) -> List[torch.Tensor]:
        raise NotImplementedError

    def require(self, path: str) -> None:
        """Raise where this builder has no ``path``: ``"tpsp"`` (a mesh
        with a model or space axis) or ``"export"`` (``torch.export``)."""
        if path in self.lacks:
            what = {"tpsp": "path on a mesh with a model or space axis",
                    "export": "torch.export program"}[path]
            name = next((k for k, v in NETWORKS.items()
                         if v is type(self)), type(self).__name__)
            raise NotImplementedError(
                f"{name} ({type(self).__name__}) has no {what}: serve it "
                "eagerly, on one device or a data-parallel mesh")

    @property
    def stem(self) -> nn.Module:
        """The first conv, the one that sees the image."""
        return self.backbone.stem

    @property
    def stem_mode(self) -> str:
        """The stem's ``layers.ConvBN.stem_mode``; settable."""
        return self.stem.stem_mode

    @stem_mode.setter
    def stem_mode(self, mode: str) -> None:
        self.stem.stem_mode = mode

    def forward_raw(self, x: torch.Tensor,
                    input_scale: Optional[torch.Tensor] = None,
                    dtype: torch.dtype = torch.float32,
                    shard=None) -> List[torch.Tensor]:
        """x [B, H, W, 3] (any real dtype; cast to ``dtype`` by the stem
        conv), or in the ``"patches"`` stem mode the stem's patches [B, Ho,
        kh, Wo, kw, 3] -> per layer [B, h, w, a * (5 + C)] in ``dtype``.
        With ``shard`` this rank's part on a TP/SP mesh (module
        docstring)."""
        if self.stem_mode != "patches":
            x = x.permute(0, 3, 1, 2)
        if shard is None:
            heads = self._heads(x, dtype, input_scale)
        else:
            self.require("tpsp")
            heads = [h.full() for h in self._heads(Sharded(x, shard), dtype,
                                                   input_scale)]
        return [h.permute(0, 2, 3, 1) for h in heads]

    def reshape_outputs(self, outputs: List[torch.Tensor]
                        ) -> List[torch.Tensor]:
        c = 5 + self.class_num
        return [o.reshape(o.shape[0], o.shape[1], o.shape[2],
                          self.anchor_num, c) for o in outputs]

    def forward(self, x: torch.Tensor,
                input_scale: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32,
                shard=None) -> List[torch.Tensor]:
        """-> per layer [B, h, w, a, 5 + C]; channel ``a * (5 + C) + e`` of
        the raw output is entry e of anchor a."""
        return self.reshape_outputs(self.forward_raw(x, input_scale, dtype,
                                                     shard))


class _TwoScaleNet(YoloNet):
    """A backbone returning (stride-16 tap, stride-32 trunk) under the
    shared two-scale head."""

    def __init__(self, anchor_num: int, class_num: int, in_hw: Sequence[int],
                 backbone: nn.Module, y1_filters: int, y2_filters: int):
        super().__init__(anchor_num, class_num, in_hw)
        self.backbone = backbone
        self.head = _TwoScaleHead(
            tap_channels=backbone.tap16_channels,
            trunk_channels=backbone.out_channels,
            out_channels=anchor_num * (class_num + 5),
            y1_filters=y1_filters, y2_filters=y2_filters)

    def _heads(self, x, dtype, input_scale):
        tap16, trunk = self.backbone(x, dtype, input_scale)
        return self.head(tap16, trunk, dtype)


class YoloMobileV1(_TwoScaleNet):
    """yolo_mobilev1: y1 width 128 if alpha > 0.8 else 192, y2 width 128."""

    def __init__(self, anchor_num: int, class_num: int, in_hw: Sequence[int],
                 alpha: float = 0.75, stem_mode: str = "default"):
        super().__init__(anchor_num, class_num, in_hw,
                         MobileNetV1(alpha=alpha, stem_mode=stem_mode),
                         128 if alpha > 0.8 else 192, 128)


class YoloMobileV2(_TwoScaleNet):
    """yolo_mobilev2: both head widths 128 if alpha > 0.7 else 192."""

    def __init__(self, anchor_num: int, class_num: int, in_hw: Sequence[int],
                 alpha: float = 1.0, stem_mode: str = "default"):
        w = 128 if alpha > 0.7 else 192
        super().__init__(anchor_num, class_num, in_hw,
                         MobileNetV2(alpha=alpha, stem_mode=stem_mode), w, w)


class TinyYolo(_TwoScaleNet):
    """tiny_yolo: y1 width 512, y2 width 256.  ``alpha`` is unused (the
    builders' uniform signature)."""

    def __init__(self, anchor_num: int, class_num: int, in_hw: Sequence[int],
                 alpha: float = 1.0, stem_mode: str = "default"):
        super().__init__(anchor_num, class_num, in_hw,
                         TinyYoloBody(stem_mode=stem_mode), 512, 256)

    @property
    def stem(self) -> nn.Module:
        return self.backbone.conv_0


class Yolo(YoloNet):
    """The full YOLOv3 on darknet53, three scales: y1 from the stride-32
    tap, y2 and y3 each from [upsample(the previous trunk, 1x1), the next
    finer tap] (that order).  ``alpha`` is unused."""

    n_out_layers = 3

    def __init__(self, anchor_num: int, class_num: int, in_hw: Sequence[int],
                 alpha: float = 1.0, stem_mode: str = "default"):
        super().__init__(anchor_num, class_num, in_hw)
        out = anchor_num * (class_num + 5)
        self.backbone = Darknet53(stem_mode=stem_mode)
        c8, c16, c32 = self.backbone.tap_channels
        self.last_512 = LastLayers(c32, 512)
        self.y1_out = darknet_head_conv(1024, out)
        self.up1_conv = DarknetConvBN(512, 256, (1, 1))
        self.last_256 = LastLayers(256 + c16, 256)
        self.y2_out = darknet_head_conv(512, out)
        self.up2_conv = DarknetConvBN(256, 128, (1, 1))
        self.last_128 = LastLayers(128 + c8, 128)
        self.y3_out = darknet_head_conv(256, out)

    def _heads(self, x, dtype, input_scale):
        tap8, tap16, tap32 = self.backbone(x, dtype, input_scale)
        x, y = self.last_512(tap32, dtype)
        y1 = self.y1_out(y, dtype)
        x = cat_channels([upsample2x(self.up1_conv(x, dtype, narrow=True)),
                          tap16])
        x, y = self.last_256(x, dtype)
        y2 = self.y2_out(y, dtype)
        x = cat_channels([upsample2x(self.up2_conv(x, dtype, narrow=True)),
                          tap8])
        _, y = self.last_128(x, dtype)
        return [y1, y2, self.y3_out(y, dtype)]


class YoloV4(YoloNet):
    """YOLOv4 (darknet ``cfg/yolov4.cfg``), three scales: the CSPDarknet53
    trunk (``models/cspdarknet.py``); SPP on its stride-32 output between
    two three-conv stacks; PANet's top-down path (each step a 1x1 and an
    upsample of the coarser output, concatenated after a 1x1 of the finer
    tap, ``[tap, upsample]``, then five convs) and bottom-up path (each
    step a stride-2 3x3 of the finer output concatenated before the
    top-down output of that scale, ``[down, earlier]``, then five convs);
    a 3x3 and an output conv a scale.  Layer 0 of the outputs is the
    coarsest grid, the reverse of the cfg's ``[yolo]`` order, and
    ``scale_x_y`` is in that order.  ``alpha`` is unused.

    The spans ``net.csp`` (the trunk), ``net.spp`` (the stacks around SPP)
    and ``net.pan`` (the rest up to the output convs, the 3x3 before each
    among it) are ``utils.trace`` ranges, once a forward."""

    n_out_layers = 3
    scale_x_y = (1.05, 1.1, 1.2)
    lacks = frozenset({"tpsp", "export"})

    def __init__(self, anchor_num: int, class_num: int, in_hw: Sequence[int],
                 alpha: float = 1.0, stem_mode: str = "default"):
        super().__init__(anchor_num, class_num, in_hw)
        out = anchor_num * (class_num + 5)
        self.backbone = CSPDarknet53(stem_mode=stem_mode)
        c8, c16, c32 = self.backbone.tap_channels
        self.spp_pre = ConvStack(c32, 512, 3)
        self.spp_post = ConvStack(4 * 512, 512, 3)
        self.up1_conv = DarknetConvBN(512, 256, (1, 1))
        self.tap16_conv = DarknetConvBN(c16, 256, (1, 1))
        self.td16 = ConvStack(512, 256, 5)
        self.up2_conv = DarknetConvBN(256, 128, (1, 1))
        self.tap8_conv = DarknetConvBN(c8, 128, (1, 1))
        self.td8 = ConvStack(256, 128, 5)
        self.y3_conv = DarknetConvBN(128, 256, (3, 3))
        self.down38 = DarknetConvBN(128, 256, (3, 3), (2, 2))
        self.bu38 = ConvStack(512, 256, 5)
        self.y2_conv = DarknetConvBN(256, 512, (3, 3))
        self.down19 = DarknetConvBN(256, 512, (3, 3), (2, 2))
        self.bu19 = ConvStack(1024, 512, 5)
        self.y1_conv = DarknetConvBN(512, 1024, (3, 3))
        # the output convs, in output order
        self.y1_out = darknet_head_conv(1024, out)
        self.y2_out = darknet_head_conv(512, out)
        self.y3_out = darknet_head_conv(256, out)

    def _heads(self, x, dtype, input_scale):
        with span("net.csp"):
            tap8, tap16, tap32 = self.backbone(x, dtype, input_scale)
        with span("net.spp"):
            n19 = self.spp_post(spp(self.spp_pre(tap32, dtype)), dtype)
        with span("net.pan"):
            up = upsample2x(self.up1_conv(n19, dtype, narrow=True))
            n38 = self.td16(cat_channels(
                [self.tap16_conv(tap16, dtype, narrow=True), up]), dtype)
            up = upsample2x(self.up2_conv(n38, dtype, narrow=True))
            n76 = self.td8(cat_channels(
                [self.tap8_conv(tap8, dtype, narrow=True), up]), dtype)
            b76 = self.y3_conv(n76, dtype, narrow=True)
            m38 = self.bu38(cat_channels(
                [self.down38(n76, dtype, narrow=True), n38]), dtype)
            b38 = self.y2_conv(m38, dtype, narrow=True)
            m19 = self.bu19(cat_channels(
                [self.down19(m38, dtype, narrow=True), n19]), dtype)
            b19 = self.y1_conv(m19, dtype, narrow=True)
        return [self.y1_out(b19, dtype), self.y2_out(b38, dtype),
                self.y3_out(b76, dtype)]


NETWORKS: Dict[str, type] = {
    "yolo_mobilev1": YoloMobileV1,
    "yolo_mobilev2": YoloMobileV2,
    "tiny_yolo": TinyYolo,
    "yolo": Yolo,
    "yolov4": YoloV4,
}


@torch.no_grad()
def init_weights(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's initialisers: lecun-normal conv kernels (truncated at two
    standard deviations), zero conv biases; BN scale 1, bias 0, mean 0,
    var 1."""
    for mod in net.modules():
        if isinstance(mod, Conv):
            fan_in = mod.weight[0].numel()
            # flax: truncated_normal(-2, 2) * sqrt(1 / fan_in) / .8796...
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
    return net


def build_network(model_def: str, in_hw, anchor_num: int, class_num: int,
                  alpha: float = 1.0,
                  generator: Optional[torch.Generator] = None) -> YoloNet:
    """Select a builder by name and initialise its weights from
    ``generator`` (a fresh one seeded 0 when none is given)."""
    if model_def not in NETWORKS:
        raise KeyError(f"unknown model_def {model_def!r}; have "
                       f"{sorted(NETWORKS)}")
    net = NETWORKS[model_def](anchor_num=anchor_num, class_num=class_num,
                              in_hw=in_hw, alpha=alpha)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return init_weights(net, generator)

"""YOLO network builders.

Counterpart of ``k210_yolo_framework_tpu/models/yolonet.py``.  A built net
takes NHWC images and returns, per output layer (layer 0 = coarsest grid =
biggest anchors), the raw head outputs ``[B, h, w, a * (5 + C)]``
(``forward_raw``) or their ``[B, h, w, a, 5 + C]`` view (``forward``), in
the compute ``dtype``.  ``net.train()`` is the JAX package's
``apply(..., train=True)``: BatchNorm on batch statistics, running
statistics updated in place; ``net.eval()`` serves.

Only ``yolo_mobilev1`` is ported so far; ``build_network`` names the others
and raises ``NotImplementedError`` for them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from k210_yolo_framework_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    DarknetConvBN,
    darknet_head_conv,
    upsample2x,
)
from k210_yolo_framework_tpu_torch.models.mobilenet_v1 import MobileNetV1

__all__ = ["YoloNet", "YoloMobileV1", "build_network", "init_weights",
           "NETWORKS"]

# builders of the JAX package that have no port yet
_NOT_PORTED = ("yolo_mobilev2", "tiny_yolo", "yolo")


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
        y1 = self.y1_out(self.y1_conv(trunk32, dtype), dtype)
        x = upsample2x(self.up_conv(trunk32, dtype))
        x = torch.cat([x, tap16], dim=1)
        y2 = self.y2_out(self.y2_conv(x, dtype), dtype)
        return [y1, y2]


class YoloNet(nn.Module):
    """A built detector: NHWC images in, per-layer head outputs out."""

    n_out_layers = 2

    def __init__(self, anchor_num: int, class_num: int,
                 in_hw: Sequence[int]):
        super().__init__()
        self.anchor_num = anchor_num
        self.class_num = class_num
        self.in_hw = tuple(in_hw)

    def _heads(self, x: torch.Tensor, dtype: torch.dtype,
               input_scale: Optional[torch.Tensor]) -> List[torch.Tensor]:
        raise NotImplementedError

    def forward_raw(self, x: torch.Tensor,
                    input_scale: Optional[torch.Tensor] = None,
                    dtype: torch.dtype = torch.float32) -> List[torch.Tensor]:
        """x [B, H, W, 3] (any real dtype; cast to ``dtype`` by the stem
        conv) -> per layer [B, h, w, a * (5 + C)] in ``dtype``."""
        heads = self._heads(x.permute(0, 3, 1, 2), dtype, input_scale)
        return [h.permute(0, 2, 3, 1) for h in heads]

    def reshape_outputs(self, outputs: List[torch.Tensor]
                        ) -> List[torch.Tensor]:
        c = 5 + self.class_num
        return [o.reshape(o.shape[0], o.shape[1], o.shape[2],
                          self.anchor_num, c) for o in outputs]

    def forward(self, x: torch.Tensor,
                input_scale: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32) -> List[torch.Tensor]:
        """-> per layer [B, h, w, a, 5 + C]; channel ``a * (5 + C) + e`` of
        the raw output is entry e of anchor a."""
        return self.reshape_outputs(self.forward_raw(x, input_scale, dtype))


class YoloMobileV1(YoloNet):
    """yolo_mobilev1: y1 width 128 if alpha > 0.8 else 192, y2 width 128."""

    def __init__(self, anchor_num: int, class_num: int, in_hw: Sequence[int],
                 alpha: float = 0.75):
        super().__init__(anchor_num, class_num, in_hw)
        self.backbone = MobileNetV1(alpha=alpha)
        self.head = _TwoScaleHead(
            tap_channels=self.backbone.tap16_channels,
            trunk_channels=self.backbone.out_channels,
            out_channels=anchor_num * (class_num + 5),
            y1_filters=128 if alpha > 0.8 else 192, y2_filters=128)

    def _heads(self, x, dtype, input_scale):
        tap16, trunk = self.backbone(x, dtype, input_scale)
        return self.head(tap16, trunk, dtype)


NETWORKS: Dict[str, type] = {"yolo_mobilev1": YoloMobileV1}


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
    if model_def in _NOT_PORTED:
        raise NotImplementedError(
            f"model_def {model_def!r} is not ported yet; ported: "
            f"{sorted(NETWORKS)}, still to port: {list(_NOT_PORTED)}")
    if model_def not in NETWORKS:
        raise KeyError(f"unknown model_def {model_def!r}; have "
                       f"{sorted(NETWORKS) + list(_NOT_PORTED)}")
    net = NETWORKS[model_def](anchor_num=anchor_num, class_num=class_num,
                              in_hw=in_hw, alpha=alpha)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return init_weights(net, generator)

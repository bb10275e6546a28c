"""K210-modified MobileNetV2 backbone.

Counterpart of ``k210_yolo_framework_tpu/models/mobilenet_v2.py``, with the
reference fork's deviations from stock MobileNetV2:

  * the stem is fixed at 32 filters (stride 2, explicit ((1, 1), (1, 1))
    pad, VALID), whatever alpha;
  * the expand convs of blocks 1 and 2 are capped at 48 and 124 channels
    when ``alpha > 0.6`` (a K210 RAM cap);
  * every stride-2 depthwise pads ((1, 1), (1, 1)) explicitly and runs
    VALID;
  * ``conv_last`` has 1280 channels unless ``alpha > 1``.

BN momentum 0.999 (eps 1e-3) everywhere; ReLU6 after the stem, each expand,
each depthwise and ``conv_last``; ``project`` is linear.  Returns the
stride-16 tap (block 13's expand output, after its ReLU6) and the stride-32
trunk (``conv_last``'s output).  The stem, or a block's ``project``, is
``wide`` where the next block is residual: its output is an addend of
that block's fp32 sum.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from k210_yolo_framework_tpu_torch.models.layers import (
    ConvBN,
    relu6,
)

__all__ = ["MobileNetV2", "make_divisible"]

BN_MOMENTUM = 0.999


def make_divisible(v: float, divisor: int = 8,
                   min_value: Optional[int] = None) -> int:
    """keras-applications' ``_make_divisible``: round to the nearest
    multiple of ``divisor``, at least ``min_value``, never below 90% of
    ``v``."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


# (filters, stride, expansion) of blocks 0..16
_BLOCKS = [
    (16, 1, 1), (24, 2, 6), (24, 1, 6),
    (32, 2, 6), (32, 1, 6), (32, 1, 6),
    (64, 2, 6), (64, 1, 6), (64, 1, 6), (64, 1, 6),
    (96, 1, 6), (96, 1, 6), (96, 1, 6),
    (160, 2, 6), (160, 1, 6), (160, 1, 6),
    (320, 1, 6),
]


class _InvertedResBlock(nn.Module):
    """[expand 1x1 (ReLU6)] -> depthwise 3x3 (ReLU6) -> project 1x1
    (linear), plus the input where the shapes allow it.  Block 0 has no
    expand conv."""

    def __init__(self, cin: int, filters: int, stride: int, expansion: int,
                 alpha: float, block_id: int,
                 expand_channel: Optional[int] = None):
        super().__init__()
        pointwise = make_divisible(int(filters * alpha), 8)
        c = cin
        self.expand = None
        if block_id:
            c = expand_channel if expand_channel else expansion * cin
            self.expand = ConvBN(cin, c, (1, 1), act=relu6,
                                 bn_momentum=BN_MOMENTUM)
        explicit = ((1, 1), (1, 1)) if stride == 2 else None
        self.depthwise = ConvBN(c, c, (3, 3), (stride, stride),
                                explicit_pad=explicit, act=relu6,
                                depthwise=True, bn_momentum=BN_MOMENTUM)
        self.project = ConvBN(c, pointwise, (1, 1), bn_momentum=BN_MOMENTUM)
        self.residual = cin == pointwise and stride == 1
        self.expand_channels = c
        self.out_channels = pointwise

    def forward(self, x, dtype: torch.dtype):
        """-> (output, the expand conv's output or None); ``x`` a tensor
        or a ``Sharded`` one.  Both BN outputs are fp32, so the residual add
        is fp32.  Without gradients the add writes into ``project``'s fresh
        output, never into ``x`` or the expand output, which the caller may
        keep as a tap."""
        inputs = x
        expand_out = None
        if self.expand is not None:
            x = expand_out = self.expand(x, dtype)
        y = self.project(self.depthwise(x, dtype), dtype,
                         residual=inputs if self.residual else None)
        return y, expand_out


class MobileNetV2(nn.Module):
    """K210-modified MobileNetV2; ``alpha`` is the reference's DEPTHMUL;
    ``stem_mode`` the stem's (``layers.ConvBN.stem_mode``)."""

    def __init__(self, alpha: float = 1.0, stem_mode: str = "default"):
        super().__init__()
        a = alpha
        self.stem = ConvBN(3, 32, (3, 3), (2, 2),
                           explicit_pad=((1, 1), (1, 1)), act=relu6,
                           bn_momentum=BN_MOMENTUM, stem_mode=stem_mode)
        c = 32
        prev = self.stem
        for bid, (f, s, e) in enumerate(_BLOCKS):
            cap = {1: 48, 2: 124}.get(bid) if a > 0.6 else None
            block = _InvertedResBlock(c, f, s, e, a, bid, cap)
            setattr(self, f"block_{bid}", block)
            prev.wide = block.residual   # prev's output: this block's skip
            prev = block.project
            if bid == 13:
                self.tap16_channels = block.expand_channels
            c = block.out_channels
        last = make_divisible(1280 * a, 8) if a > 1.0 else 1280
        self.conv_last = ConvBN(c, last, (1, 1), act=relu6,
                                bn_momentum=BN_MOMENTUM)
        self.out_channels = last

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32,
                input_scale: Optional[torch.Tensor] = None):
        """x: NCHW.  ``input_scale`` [B]: per-image normalisation folded in
        after the stem conv."""
        x = self.stem(x, dtype, input_scale)
        tap16 = None
        for bid in range(len(_BLOCKS)):
            x, expand_out = getattr(self, f"block_{bid}")(x, dtype)
            if bid == 13:   # 'block_13_expand_relu'
                tap16 = expand_out
        return tap16, self.conv_last(x, dtype)

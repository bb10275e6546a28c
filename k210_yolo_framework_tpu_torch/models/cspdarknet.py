"""YOLOv4's trunk, CSPDarknet53, and its neck's SPP and PANet stacks.

Written from darknet's ``cfg/yolov4.cfg`` (Bochkovskiy, Wang and Liao,
arXiv:2004.10934); the JAX package has no counterpart.  Every conv is a
``DarknetConvBN``: no bias, BN, and Mish in the trunk (72 convs), LeakyReLU
0.1 in the neck.

* The stem: a 3x3 conv of 32 filters.
* Five CSP stages of 64, 128, 256, 512 and 1024 filters with 1, 2, 8, 8
  and 4 residual units.  A stage is a stride-2 3x3 ``down`` conv, two 1x1
  branches ``part_a`` and ``part_b`` of its output, the residual units on
  B (a 1x1 and a 3x3, the 3x3's output plus the unit's input), a 1x1
  ``post_b`` on B, ``concat[B, A]`` and a 1x1 ``transition`` to the
  stage's width.  Stage 1's branches keep its 64 channels and its unit
  narrows to 32 inside; the others split to half width, their units
  keeping it.
* The taps: stage 3 (stride 8), stage 4 (stride 16) and stage 5 (stride
  32).

A stride-2 conv pads top and left by one, as the port's darknet53 does;
darknet pads one on every side, but every map this net takes a stride-2
conv of has an even size, whose last window ends on its last row and
column: the bottom and right pad is never read, so the two are equal.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from k210_yolo_framework_tpu_torch.models.layers import (
    DarknetConvBN,
    cat_channels,
    mish,
)

__all__ = ["CSPDarknet53", "ConvStack"]

# (filters, residual units) of stage_1..stage_5
_CSP_STAGES = ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4))


class _CSPStage(nn.Module):
    """``down``, ``part_a``, ``part_b``, ``res_<i>_1x1`` /
    ``res_<i>_3x3``, ``post_b`` and ``transition`` (module docstring).
    ``part_b`` and each unit's 3x3 are ``wide``: their outputs are addends
    of the units' fp32 sums."""

    def __init__(self, cin: int, filters: int, num_blocks: int,
                 first: bool):
        super().__init__()
        half = filters if first else filters // 2
        inner = filters // 2 if first else half
        self.down = DarknetConvBN(cin, filters, (3, 3), (2, 2), act=mish)
        self.part_a = DarknetConvBN(filters, half, (1, 1), act=mish)
        self.part_b = DarknetConvBN(filters, half, (1, 1), act=mish,
                                    wide=True)
        for i in range(num_blocks):
            setattr(self, f"res_{i}_1x1",
                    DarknetConvBN(half, inner, (1, 1), act=mish))
            setattr(self, f"res_{i}_3x3",
                    DarknetConvBN(inner, half, (3, 3), act=mish, wide=True))
        self.post_b = DarknetConvBN(half, half, (1, 1), act=mish)
        self.transition = DarknetConvBN(2 * half, filters, (1, 1), act=mish)
        self.num_blocks = num_blocks

    def forward(self, x, dtype: torch.dtype):
        x = self.down(x, dtype)
        a = self.part_a(x, dtype)
        b = self.part_b(x, dtype)
        for i in range(self.num_blocks):
            y = getattr(self, f"res_{i}_1x1")(b, dtype)
            b = getattr(self, f"res_{i}_3x3")(y, dtype, residual=b)
        b = self.post_b(b, dtype)
        return self.transition(cat_channels([b, a]), dtype)


class CSPDarknet53(nn.Module):
    """The 72-conv CSPDarknet53 trunk; returns the (stride-8, stride-16,
    stride-32) taps, the outputs of ``stage_3``, ``stage_4`` and
    ``stage_5``.  ``stem_mode``: the stem's."""

    def __init__(self, stem_mode: str = "default"):
        super().__init__()
        self.stem = DarknetConvBN(3, 32, (3, 3), stem_mode=stem_mode,
                                  act=mish)
        c = 32
        for i, (f, n) in enumerate(_CSP_STAGES, start=1):
            setattr(self, f"stage_{i}", _CSPStage(c, f, n, first=i == 1))
            c = f
        self.tap_channels = tuple(f for f, _ in _CSP_STAGES[2:])

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32,
                input_scale: Optional[torch.Tensor] = None):
        """x: NCHW.  ``input_scale`` [B]: per-image normalisation folded in
        after the stem conv."""
        x = self.stem(x, dtype, input_scale)
        x = self.stage_2(self.stage_1(x, dtype), dtype)
        tap8 = self.stage_3(x, dtype)
        tap16 = self.stage_4(tap8, dtype)
        return tap8, tap16, self.stage_5(tap16, dtype)


class ConvStack(nn.Module):
    """``n`` leaky ConvBNs ``conv_0``.. alternating 1x1 to ``filters`` and
    3x3 to twice that, starting and ending with a 1x1 (n odd): YOLOv4's
    neck blocks around SPP and in PANet's two paths."""

    def __init__(self, cin: int, filters: int, n: int):
        super().__init__()
        for i in range(n):
            f, k = (filters, 1) if i % 2 == 0 else (2 * filters, 3)
            setattr(self, f"conv_{i}", DarknetConvBN(cin, f, (k, k)))
            cin = f
        self.n = n

    def forward(self, x, dtype: torch.dtype):
        for i in range(self.n):
            x = getattr(self, f"conv_{i}")(x, dtype)
        return x

"""Darknet bodies: tiny-yolo v3 and the full darknet53.

Counterpart of ``k210_yolo_framework_tpu/models/darknet.py``
(``TinyYoloBody``, ``_ResBlockBody``, ``Darknet53``, ``LastLayers``).  Every
conv is a ``DarknetConvBN`` (no bias, BN momentum 0.99, LeakyReLU 0.1); a
stride-2 one pads top/left only.  The tiny body's 2x2 max-pools are flax's
SAME pools (``layers.max_pool_same``: -inf after, never before).  The
blocks take their widths as constructor arguments, so tests can build them
narrow.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from k210_yolo_framework_tpu_torch.models.layers import (
    DarknetConvBN,
    max_pool_same,
)

__all__ = ["TinyYoloBody", "Darknet53", "LastLayers"]

_TINY_FILTERS = (16, 32, 64, 128, 256, 512, 1024, 256)   # conv_0..conv_7
# (filters, residual units) of stage_1..stage_5
_DARKNET53_STAGES = ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4))


class TinyYoloBody(nn.Module):
    """Tiny YOLOv3 body: conv/pool ladder, the stride-1 pool before
    ``conv_6``; returns (stride-16 tap ``conv_4``, stride-32 trunk
    ``conv_7``).  ``stem_mode``: ``conv_0``'s."""

    def __init__(self, stem_mode: str = "default"):
        super().__init__()
        c = 3
        for i, f in enumerate(_TINY_FILTERS):
            kernel = (1, 1) if i == 7 else (3, 3)
            setattr(self, f"conv_{i}", DarknetConvBN(
                c, f, kernel, stem_mode=stem_mode if i == 0 else "default"))
            c = f
        self.tap16_channels = _TINY_FILTERS[4]
        self.out_channels = _TINY_FILTERS[7]
        self.pool = max_pool_same     # (x, stride) -> x; a test may swap it

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32,
                input_scale: Optional[torch.Tensor] = None):
        """x: NCHW.  ``input_scale`` [B]: per-image normalisation folded in
        after the stem conv."""
        for i in range(4):
            x = getattr(self, f"conv_{i}")(x, dtype,
                                           input_scale if i == 0 else None)
            x = self.pool(x, 2)
        x1 = self.conv_4(x, dtype)
        x = self.conv_5(self.pool(x1, 2), dtype)
        x = self.conv_6(self.pool(x, 1), dtype)
        return x1, self.conv_7(x, dtype)


class _ResBlockBody(nn.Module):
    """A stride-2 ``down`` conv, then ``num_blocks`` residual units
    (1x1 to filters / 2, 3x3 back to filters)."""

    def __init__(self, cin: int, filters: int, num_blocks: int):
        super().__init__()
        self.down = DarknetConvBN(cin, filters, (3, 3), (2, 2))
        for i in range(num_blocks):
            setattr(self, f"res_{i}_1x1",
                    DarknetConvBN(filters, filters // 2, (1, 1)))
            setattr(self, f"res_{i}_3x3",
                    DarknetConvBN(filters // 2, filters, (3, 3)))
        self.num_blocks = num_blocks

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = self.down(x, dtype)
        for i in range(self.num_blocks):
            y = getattr(self, f"res_{i}_1x1")(x, dtype)
            y = getattr(self, f"res_{i}_3x3")(y, dtype)
            # without gradients the sum goes into y, the 3x3's fresh
            # output: x may be a tap the caller keeps
            x = x + y if torch.is_grad_enabled() else y.add_(x)
        return x


class Darknet53(nn.Module):
    """The 52-conv darknet body; returns the (stride-8, stride-16,
    stride-32) taps, the outputs of ``stage_3``, ``stage_4`` and
    ``stage_5``.  ``stem_mode``: the stem's."""

    def __init__(self, stem_mode: str = "default"):
        super().__init__()
        self.stem = DarknetConvBN(3, 32, (3, 3), stem_mode=stem_mode)
        c = 32
        for i, (f, n) in enumerate(_DARKNET53_STAGES, start=1):
            setattr(self, f"stage_{i}", _ResBlockBody(c, f, n))
            c = f
        self.tap_channels = tuple(f for f, _ in _DARKNET53_STAGES[2:])

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32,
                input_scale: Optional[torch.Tensor] = None):
        """x: NCHW.  ``input_scale`` [B]: per-image normalisation folded in
        after the stem conv."""
        x = self.stem(x, dtype, input_scale)
        x = self.stage_2(self.stage_1(x, dtype), dtype)
        tap8 = self.stage_3(x, dtype)
        tap16 = self.stage_4(tap8, dtype)
        return tap8, tap16, self.stage_5(tap16, dtype)


class LastLayers(nn.Module):
    """Five alternating 1x1 / 3x3 ``trunk`` convs and a 3x3 ``branch``;
    returns (the trunk, for the next scale, and the branch, for the
    head)."""

    def __init__(self, cin: int, filters: int):
        super().__init__()
        f = filters
        for i, (ff, k) in enumerate([(f, 1), (f * 2, 3), (f, 1), (f * 2, 3),
                                     (f, 1)]):
            setattr(self, f"trunk_{i}", DarknetConvBN(cin, ff, (k, k)))
            cin = ff
        self.branch = DarknetConvBN(f, f * 2, (3, 3))

    def forward(self, x: torch.Tensor, dtype: torch.dtype):
        for i in range(5):
            x = getattr(self, f"trunk_{i}")(x, dtype)
        return x, self.branch(x, dtype)

"""K210-modified MobileNetV1 backbone.

Counterpart of ``k210_yolo_framework_tpu/models/mobilenet_v1.py``, with the
reference fork's deviations from stock MobileNet:

  * block 1 pointwise filters = ``40 if alpha == 1 else 64``;
  * the stem activates with LeakyReLU(0.3) instead of ReLU6;
  * depthwise convs activate with unbounded ReLU, pointwise with
    LeakyReLU(0.3);
  * every stride-2 conv pads ((1, 1), (1, 1)) explicitly and runs VALID.

Returns the stride-16 tap (block 11's output) and the stride-32 trunk.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from k210_yolo_framework_tpu_torch.models.layers import (
    ConvBN,
    leaky_relu,
    relu,
)

__all__ = ["MobileNetV1"]

# (pointwise filters before alpha-scaling, stride) of blocks 2..13
_BLOCKS = [
    (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
    (512, 1), (512, 1), (512, 1), (512, 1), (512, 1),
    (1024, 2), (1024, 1),
]


class _DWBlock(nn.Module):
    """Depthwise 3x3 (ReLU) + pointwise 1x1 (LeakyReLU 0.3)."""

    def __init__(self, cin: int, filters: int, strides: Tuple[int, int]):
        super().__init__()
        explicit = ((1, 1), (1, 1)) if tuple(strides) == (2, 2) else None
        self.dw = ConvBN(cin, cin, (3, 3), strides, explicit_pad=explicit,
                         act=relu, depthwise=True)
        self.pw = ConvBN(cin, filters, (1, 1), act=leaky_relu(0.3))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.pw(self.dw(x, dtype), dtype)


class MobileNetV1(nn.Module):
    """K210-modified MobileNetV1; ``alpha`` is the reference's DEPTHMUL;
    ``stem_mode`` the stem's (``layers.ConvBN.stem_mode``)."""

    def __init__(self, alpha: float = 1.0, stem_mode: str = "default"):
        super().__init__()
        a = alpha
        c = int(32 * a)
        self.stem = ConvBN(3, c, (3, 3), (2, 2),
                           explicit_pad=((1, 1), (1, 1)),
                           act=leaky_relu(0.3), stem_mode=stem_mode)
        block1 = int((40 if a == 1.0 else 64) * a)
        self.block_1 = _DWBlock(c, block1, (1, 1))
        c = block1
        for i, (f, s) in enumerate(_BLOCKS, start=2):
            setattr(self, f"block_{i}", _DWBlock(c, int(f * a), (s, s)))
            c = int(f * a)
        self.tap16_channels = int(512 * a)
        self.out_channels = c

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32,
                input_scale: Optional[torch.Tensor] = None):
        """x: NCHW, or the stem's patches in the ``"patches"`` stem mode.
        ``input_scale`` [B]: per-image normalisation folded in after the
        stem conv."""
        x = self.stem(x, dtype, input_scale)
        x = self.block_1(x, dtype)
        tap16 = None
        for i in range(2, 2 + len(_BLOCKS)):
            x = getattr(self, f"block_{i}")(x, dtype)
            if i == 11:  # 'conv_pw_11_relu'
                tap16 = x
        return tap16, x

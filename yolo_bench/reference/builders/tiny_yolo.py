"""tiny_yolo in plain fp32 PyTorch: the K210 framework's tiny YOLOv3 body
(``models/yolonet.py``'s conv / max-pool ladder) under the two-scale head
it shares with yolo_mobilev1.  Written from that description, not from the
program; a builder file as ``nets.builder_file`` describes it.

* ``conv_0`` .. ``conv_3``: 3x3 darknet convs of 16, 32, 64 and 128
  filters, each followed by a 2x2 stride-2 max-pool;
* ``conv_4``: 3x3, 256 filters, the stride-16 tap; a 2x2 stride-2 pool;
* ``conv_5``: 3x3, 512; a 2x2 stride-1 pool, so the grid stays;
* ``conv_6``: 3x3, 1024; ``conv_7``: 1x1, 256, the stride-32 trunk;
* the head: y1 from the trunk (3x3 to 512, the output conv); y2 from
  [upsample(the trunk 1x1 to 128), the tap] (3x3 to 256, the output conv).

The pools are flax's SAME pools: a window that runs past the map reads
-inf there, and the pad goes after (right and bottom), never before.  So
the stride-1 pool before ``conv_6`` pads right and bottom by one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from yolo_bench.reference import nets as RN

FILTERS = (16, 32, 64, 128, 256, 512, 1024, 256)     # conv_0 .. conv_7


def pool(x: torch.Tensor, stride: int) -> torch.Tensor:
    """2x2 max-pool, SAME: ceil(n / stride) outputs a side, the windows
    that run past the map padded with -inf after it."""
    pads = []
    for n in (x.shape[3], x.shape[2]):                # F.pad: W, then H
        out = -(-n // stride)
        pads += [0, max((out - 1) * stride + 2 - n, 0)]
    return F.max_pool2d(F.pad(x, pads, value=float("-inf")), 2, stride)


class _Body(nn.Module):
    def __init__(self):
        super().__init__()
        c = 3
        for i, f in enumerate(FILTERS):
            setattr(self, f"conv_{i}", RN.DarkConv(c, f, 1 if i == 7 else 3))
            c = f

    def forward(self, x, ctx):
        for i in range(4):
            x = pool(getattr(self, f"conv_{i}")(x, ctx), 2)
        tap = self.conv_4(x, ctx)
        x = self.conv_5(pool(tap, 2), ctx)
        x = self.conv_6(pool(x, 1), ctx)
        return tap, self.conv_7(x, ctx)


class Net(nn.Module):
    def __init__(self, anchors: int, classes: int, alpha: float = 1.0):
        super().__init__()
        self.backbone = _Body()
        self.head = RN._TwoScaleHead(FILTERS[4], FILTERS[7],
                                     anchors * (5 + classes), 512, 256)

    def heads(self, x, ctx):
        return self.head(*self.backbone(x, ctx), ctx)

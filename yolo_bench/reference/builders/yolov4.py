"""YOLOv4 in plain fp32 PyTorch (Bochkovskiy, Wang and Liao,
arXiv:2004.10934), written from darknet's ``cfg/yolov4.cfg``, not from the
program; a builder file as ``nets.builder_file`` describes it.

* The stem: a 3x3 conv of 32 filters, then five CSP stages of 64, 128,
  256, 512 and 1024 filters with 1, 2, 8, 8 and 4 residual units.  A
  stage: a stride-2 3x3 ``down`` conv; 1x1 convs ``part_a`` and ``part_b``
  of its output; on B the units (a 1x1 ``res_<i>_1x1``, a 3x3
  ``res_<i>_3x3``, the unit's input added); a 1x1 ``post_b``;
  ``concat[B, A]``; a 1x1 ``transition``.  Stage 1's A and B keep 64
  channels and its unit's 1x1 has 32; the other stages split to half
  width.  Every trunk conv is followed by Mish.
* SPP on the stride-32 output: three convs (1x1 512, 3x3 1024, 1x1 512),
  ``concat[maxpool13, maxpool9, maxpool5, x]`` (stride 1, -inf past the
  map), three convs.
* PANet: top down, a 1x1 and an upsample of the coarser output,
  ``concat[1x1 of the finer tap, upsample]``, five convs; bottom up, a
  stride-2 3x3 of the finer output, ``concat[it, the top-down output of
  that scale]``, five convs.  A 3x3 and the output conv a scale.  Every
  neck conv is followed by LeakyReLU 0.1.
* The stride-2 convs pad the top and left by one (``nets.DarkConv``);
  darknet pads one on every side, and on the even maps here the bottom
  and right pad is never read.

Parameter names are the program's state dict's; the output convs are the
only biased ones, registered in output order (19x19 first).
``SCALE_X_Y`` is the cfg's ``scale_x_y`` in that order, and
:func:`decode` is darknet's: ``x = (i + sigmoid(tx) * s - (s - 1) / 2) /
w``, ``w = exp(tw) * anchor``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from yolo_bench.reference import nets as RN

# the cfg's [yolo] scale_x_y, coarsest grid first (19, 38, 76 at 608)
SCALE_X_Y = (1.05, 1.1, 1.2)
STAGES = ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4))


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


class _Conv(nn.Module):
    """conv + BN + an activation under the program's scope
    ``dark_conv_bn``; Mish unless ``leaky``."""

    def __init__(self, cin, cout, k, stride=1, leaky=False):
        super().__init__()
        pads = (1, 0, 1, 0) if stride == 2 else None
        self.dark_conv_bn = RN.ConvBN(cin, cout, k, stride, pads,
                                      act=RN.leaky(0.1) if leaky else mish)

    def forward(self, x, ctx):
        return self.dark_conv_bn(x, ctx)


class _Stage(nn.Module):
    def __init__(self, cin, f, n, first):
        super().__init__()
        half = f if first else f // 2
        inner = f // 2 if first else half
        self.down = _Conv(cin, f, 3, 2)
        self.part_a = _Conv(f, half, 1)
        self.part_b = _Conv(f, half, 1)
        for i in range(n):
            setattr(self, f"res_{i}_1x1", _Conv(half, inner, 1))
            setattr(self, f"res_{i}_3x3", _Conv(inner, half, 3))
        self.post_b = _Conv(half, half, 1)
        self.transition = _Conv(2 * half, f, 1)
        self.n = n

    def forward(self, x, ctx):
        x = self.down(x, ctx)
        a, b = self.part_a(x, ctx), self.part_b(x, ctx)
        for i in range(self.n):
            y = getattr(self, f"res_{i}_1x1")(b, ctx)
            b = b + getattr(self, f"res_{i}_3x3")(y, ctx)
        return self.transition(torch.cat([self.post_b(b, ctx), a], 1), ctx)


class _Trunk(nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = _Conv(3, 32, 3)
        c = 32
        for i, (f, n) in enumerate(STAGES, start=1):
            setattr(self, f"stage_{i}", _Stage(c, f, n, i == 1))
            c = f

    def forward(self, x, ctx):
        x = self.stage_2(self.stage_1(self.stem(x, ctx), ctx), ctx)
        t8 = self.stage_3(x, ctx)
        t16 = self.stage_4(t8, ctx)
        return t8, t16, self.stage_5(t16, ctx)


class _Stack(nn.Module):
    """Leaky convs ``conv_<i>``: 1x1 to f, 3x3 to 2f, ..., a 1x1 last."""

    def __init__(self, cin, f, n):
        super().__init__()
        for i in range(n):
            c, k = (f, 1) if i % 2 == 0 else (2 * f, 3)
            setattr(self, f"conv_{i}", _Conv(cin, c, k, leaky=True))
            cin = c
        self.n = n

    def forward(self, x, ctx):
        for i in range(self.n):
            x = getattr(self, f"conv_{i}")(x, ctx)
        return x


def _pool(x: torch.Tensor, k: int) -> torch.Tensor:
    return F.max_pool2d(F.pad(x, (k // 2,) * 4, value=float("-inf")), k, 1)


class Net(nn.Module):
    def __init__(self, anchors: int, classes: int, alpha: float = 1.0):
        super().__init__()
        out = anchors * (5 + classes)
        self.backbone = _Trunk()
        self.spp_pre = _Stack(1024, 512, 3)
        self.spp_post = _Stack(2048, 512, 3)
        self.up1_conv = _Conv(512, 256, 1, leaky=True)
        self.tap16_conv = _Conv(512, 256, 1, leaky=True)
        self.td16 = _Stack(512, 256, 5)
        self.up2_conv = _Conv(256, 128, 1, leaky=True)
        self.tap8_conv = _Conv(256, 128, 1, leaky=True)
        self.td8 = _Stack(256, 128, 5)
        self.y3_conv = _Conv(128, 256, 3, leaky=True)
        self.down38 = _Conv(128, 256, 3, 2, leaky=True)
        self.bu38 = _Stack(512, 256, 5)
        self.y2_conv = _Conv(256, 512, 3, leaky=True)
        self.down19 = _Conv(256, 512, 3, 2, leaky=True)
        self.bu19 = _Stack(1024, 512, 5)
        self.y1_conv = _Conv(512, 1024, 3, leaky=True)
        self.y1_out = RN.HeadConv(1024, out)
        self.y2_out = RN.HeadConv(512, out)
        self.y3_out = RN.HeadConv(256, out)

    def heads(self, x, ctx):
        t8, t16, t32 = self.backbone(x, ctx)
        x = self.spp_pre(t32, ctx)
        x = torch.cat([_pool(x, 13), _pool(x, 9), _pool(x, 5), x], 1)
        n19 = self.spp_post(x, ctx)
        up = RN.up2(self.up1_conv(n19, ctx))
        n38 = self.td16(torch.cat([self.tap16_conv(t16, ctx), up], 1), ctx)
        up = RN.up2(self.up2_conv(n38, ctx))
        n76 = self.td8(torch.cat([self.tap8_conv(t8, ctx), up], 1), ctx)
        m38 = self.bu38(torch.cat([self.down38(n76, ctx), n38], 1), ctx)
        m19 = self.bu19(torch.cat([self.down19(m38, ctx), n19], 1), ctx)
        return [self.y1_out(self.y1_conv(m19, ctx), ctx),
                self.y2_out(self.y2_conv(m38, ctx), ctx),
                self.y3_out(self.y3_conv(n76, ctx), ctx)]


def decode(logits: Sequence[torch.Tensor], anchors, in_hw,
           img_hws: torch.Tensor):
    """Darknet's decode, as ``serve.decode`` lays it out: per layer [B, h,
    w, a, 5 + C] logits -> (boxes [B, N, 4] as y0, x0, y1, x1 pixels of
    each original image, scores [B, N, C]), candidates in layer, row,
    column, anchor order; ``x = (i + sigmoid(tx) * s - (s - 1) / 2) / w``
    with the layer's ``SCALE_X_Y``, ``w = exp(tw) * anchor``, the
    letterbox undone with the framework's ``correct_box``, score =
    sigmoid(class) * sigmoid(objectness)."""
    boxes, scores = [], []
    hw = img_hws.to(torch.float32)
    tgt = torch.tensor([float(in_hw[0]), float(in_hw[1])], device=hw.device)
    new = torch.clamp_min(torch.round(hw * torch.min(tgt / hw, dim=-1,
                                                     keepdim=True).values),
                          1.0)
    off = ((tgt - new) / 2.0 / tgt)[:, None, :]                    # (y, x)
    mag = (tgt / new)[:, None, :]
    for layer, (p, s) in enumerate(zip(logits, SCALE_X_Y)):
        p = p.to(torch.float32)
        b, gh, gw, na, _ = p.shape
        gy, gx = torch.meshgrid(torch.arange(gh, device=p.device),
                                torch.arange(gw, device=p.device),
                                indexing="ij")
        anc = torch.as_tensor(anchors[layer], dtype=torch.float32,
                              device=p.device)                     # (w, h)
        cx = (gx[..., None] + torch.sigmoid(p[..., 0]) * s - (s - 1) / 2) / gw
        cy = (gy[..., None] + torch.sigmoid(p[..., 1]) * s - (s - 1) / 2) / gh
        w = torch.exp(p[..., 2]) * anc[:, 0]
        h = torch.exp(p[..., 3]) * anc[:, 1]
        yx = (torch.stack([cy, cx], -1).reshape(b, -1, 2) - off) * mag
        size = torch.stack([h, w], -1).reshape(b, -1, 2) * mag
        corners = torch.cat([yx - size / 2, yx + size / 2], -1)
        boxes.append(corners * torch.cat([hw, hw], -1)[:, None, :])
        scores.append((torch.sigmoid(p[..., 5:])
                       * torch.sigmoid(p[..., 4:5])).reshape(b, -1,
                                                             p.shape[-1] - 5))
    return torch.cat(boxes, 1), torch.cat(scores, 1)

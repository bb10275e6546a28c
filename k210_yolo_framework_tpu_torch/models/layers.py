"""Conv building blocks, eval path, as ``nn.Module``s.

Counterpart of ``k210_yolo_framework_tpu/models/layers.py`` (``ConvBN``,
``DarknetConvBN``, ``darknet_head_conv``, ``leaky_relu``, ``relu6``,
``upsample2x``).  Inside the net tensors are NCHW; the public entry points
(``models/yolonet.py``) take and return NHWC, as the JAX package does.

Where the rounding happens follows flax: each conv casts its input and its
weights to the compute ``dtype`` and returns that dtype; BatchNorm runs in
fp32 (eval mode, running statistics, eps 1e-3) and so do the activations.
Parameter names follow the flax scopes (``conv.weight`` for ``conv/kernel``,
``bn.weight`` for ``bn/scale``), so ``training/checkpoint.py`` maps a native
checkpoint mechanically.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["BatchNorm", "Conv", "ConvBN", "DarknetConvBN",
           "darknet_head_conv", "leaky_relu", "relu", "relu6", "upsample2x"]

Pads = Tuple[Tuple[int, int], Tuple[int, int]]

_BN_EPS = 1e-3  # keras BatchNormalization's default, as the reference uses


def leaky_relu(alpha: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """LeakyReLU, in place on the fp32 BN output.  Equal to the JAX
    package's ``max(x, alpha * x)`` for ``0 <= alpha <= 1``."""
    if not 0.0 <= alpha <= 1.0:
        raise ValueError(f"leaky_relu needs 0 <= alpha <= 1, got {alpha}")

    def act(x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(x, alpha, inplace=True)

    return act


def relu(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x, inplace=True)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of an NCHW tensor (keras
    ``UpSampling2D(2)``)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _same_pads(kernel: Tuple[int, int]) -> Pads:
    """XLA 'SAME' padding of a stride-1 conv: the odd pixel goes after."""
    return tuple(((k - 1) // 2, (k - 1) - (k - 1) // 2) for k in kernel)


class Conv(nn.Module):
    """A 2-D convolution holding ``weight`` [O, I/groups, kh, kw] and an
    optional ``bias``; it runs in the ``dtype`` it is called with.  The
    weights are left uninitialised: ``models.yolonet.init_weights`` or a
    loaded state dict fills them."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1),
                 pads: Pads = ((0, 0), (0, 0)), groups: int = 1,
                 use_bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(cout, cin // groups, kernel[0], kernel[1]))
        self.bias = nn.Parameter(torch.empty(cout)) if use_bias else None
        self.strides = tuple(strides)
        self.pads = tuple(tuple(p) for p in pads)
        self.groups = groups

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        (top, bottom), (left, right) = self.pads
        if top == bottom and left == right:
            padding = (top, left)
        else:
            x = F.pad(x, (left, right, top, bottom))
            padding = (0, 0)
        bias = None if self.bias is None else self.bias.to(dtype)
        return F.conv2d(x.to(dtype), self.weight.to(dtype), bias,
                        self.strides, padding, 1, self.groups)


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over channels, in fp32, in flax's order:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + _BN_EPS) * self.weight
        y = x.to(torch.float32) - self.running_mean[:, None, None]
        return y.mul_(mul[:, None, None]).add_(self.bias[:, None, None])


class ConvBN(nn.Module):
    """Bias-free conv (or depthwise conv) -> BN (eps 1e-3) -> activation.

    ``explicit_pad``: ((top, bottom), (left, right)) zero padding before a
    VALID conv, how the reference writes every stride-2 conv; otherwise
    stride-1 convs are SAME and others VALID."""

    def __init__(self, cin: int, features: int,
                 kernel: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1),
                 explicit_pad: Optional[Pads] = None,
                 act: Optional[Callable] = None, depthwise: bool = False):
        super().__init__()
        if explicit_pad is not None:
            pads = explicit_pad
        elif tuple(strides) == (1, 1):
            pads = _same_pads(kernel)
        else:
            pads = ((0, 0), (0, 0))
        cout = cin if depthwise else features
        self.conv = Conv(cin, cout, kernel, strides, pads,
                         groups=cin if depthwise else 1)
        self.bn = BatchNorm(cout)
        self.act = act

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32,
                post_conv_scale: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        x = self.conv(x, dtype)
        if post_conv_scale is not None:
            # per-image scalar folded in after the conv: conv(x * s) ==
            # conv(x) * s, so raw 0..255 pixels can go in and the
            # reference's per-image /max normalisation happens here (the
            # identity needs the bias-free conv).  The scale is cast to the
            # conv output's dtype first, as in flax.
            x = x * post_conv_scale.to(x.dtype)[:, None, None, None]
        x = self.bn(x)
        if self.act is not None:
            x = self.act(x)
        return x


class DarknetConvBN(nn.Module):
    """``DarknetConv2D_BN_Leaky``: no bias, BN, LeakyReLU 0.1; the stride-2
    variant pads top/left only."""

    def __init__(self, cin: int, features: int,
                 kernel: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1)):
        super().__init__()
        explicit = ((1, 0), (1, 0)) if tuple(strides) == (2, 2) else None
        self.dark_conv_bn = ConvBN(cin, features, kernel, strides,
                                   explicit_pad=explicit,
                                   act=leaky_relu(0.1))

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32,
                post_conv_scale: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        return self.dark_conv_bn(x, dtype, post_conv_scale)


class darknet_head_conv(nn.Module):  # noqa: N801 (the JAX package's name)
    """Final 1x1 ``DarknetConv2D`` with bias, no BN or activation."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.dark_conv_out = Conv(cin, features, (1, 1), use_bias=True)

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return self.dark_conv_out(x, dtype)

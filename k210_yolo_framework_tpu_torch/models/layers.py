"""Conv building blocks as ``nn.Module``s, for serving and training.

Counterpart of ``k210_yolo_framework_tpu/models/layers.py`` (``ConvBN``,
``DarknetConvBN``, ``darknet_head_conv``, ``leaky_relu``, ``relu6``,
``upsample2x``) and of flax's 2x2 ``max_pool(..., padding="SAME")``
(``max_pool_same``); ``smooth_witness`` smooths those kinks for checks
of gradients.  Inside the net tensors are NCHW; the public entry points
(``models/yolonet.py``) take and return NHWC, as the JAX package does.

Where the rounding happens follows flax: each conv casts its input and its
weights to the compute ``dtype`` and returns that dtype; BatchNorm runs in
fp32 (eps 1e-3, momentum per module: 0.99 unless a builder says
otherwise) and so do the activations.  ``module.train()`` puts
BatchNorm on batch statistics (flax's ``train=True``), ``.eval()`` on the
running ones.  Under ``torch.no_grad()`` / ``inference_mode`` BatchNorm and
the activations work in place on the fresh conv output, which serving
relies on; with gradients on they are out of place, as autograd needs.
Parameter names follow the flax scopes (``conv.weight`` for ``conv/kernel``,
``bn.weight`` for ``bn/scale``), so ``training/checkpoint.py`` maps a native
checkpoint mechanically.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["BatchNorm", "Conv", "ConvBN", "DarknetConvBN",
           "darknet_head_conv", "leaky_relu", "max_pool_same", "relu",
           "relu6", "smooth_max_pool_same", "smooth_witness", "upsample2x"]

Pads = Tuple[Tuple[int, int], Tuple[int, int]]

_BN_EPS = 1e-3  # keras BatchNormalization's default, as the reference uses


class _LeakyReLU(torch.autograd.Function):
    """LeakyReLU whose gradient is ``where(x >= 0, g, alpha * g)``: slope 1
    at x == 0, as the JAX package pins it (its custom_jvp; TF's gradient).
    ``F.leaky_relu`` gives alpha there and ``torch.maximum(x, alpha * x)``
    splits the tie.  The backward reads the output, whose sign is the
    input's for alpha > 0, so no extra tensor is kept."""

    @staticmethod
    def forward(ctx, x, alpha):
        y = F.leaky_relu(x, alpha)
        ctx.alpha = alpha
        ctx.save_for_backward(y if alpha > 0 else x)
        return y

    @staticmethod
    def backward(ctx, g):
        (sign_of,) = ctx.saved_tensors
        return torch.where(sign_of >= 0, g, g * ctx.alpha), None


def leaky_relu(alpha: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """LeakyReLU on the fp32 BN output, equal to the JAX package's
    ``max(x, alpha * x)`` for ``0 <= alpha <= 1``: in place without
    gradients, else through :class:`_LeakyReLU`."""
    if not 0.0 <= alpha <= 1.0:
        raise ValueError(f"leaky_relu needs 0 <= alpha <= 1, got {alpha}")

    def act(x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled():
            return _LeakyReLU.apply(x, alpha)
        return F.leaky_relu(x, alpha, inplace=True)

    return act


def relu(x: torch.Tensor) -> torch.Tensor:
    """ReLU (gradient 0 at x == 0 in both frameworks); in place without
    gradients."""
    return F.relu(x, inplace=not torch.is_grad_enabled())


class _ReLU6(torch.autograd.Function):
    """ReLU6 whose gradient is JAX's for ``minimum(relu(x), 6)``: ``g`` for
    0 < x < 6, ``0.5 * g`` at x == 6 (``minimum`` splits a tie), 0 elsewhere
    (0 included: relu's gradient there).  ``torch.clamp`` gives ``g`` at
    both ends."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp(x, 0.0, 6.0)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        inside = (x > 0) & (x < 6)
        return torch.where(inside, g, torch.where(x == 6, g * 0.5,
                                                  torch.zeros_like(g)))


def relu6(x: torch.Tensor) -> torch.Tensor:
    """ReLU6 (NaN stays NaN), with JAX's gradient; in place without
    gradients."""
    if torch.is_grad_enabled():
        return _ReLU6.apply(x)
    return torch.clamp_(x, 0.0, 6.0)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of an NCHW tensor (keras
    ``UpSampling2D(2)``)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _pool_pads(x: torch.Tensor, stride: int) -> Tuple[int, int, int, int]:
    """``F.pad``'s (left, right, top, bottom) for XLA's SAME 2x2 window on
    an NCHW tensor: at most one, after (stride 1: one row and one column;
    stride 2: where the size is odd)."""
    ph, pw = (max((-(-n // stride) - 1) * stride + 2 - n, 0)
              for n in x.shape[-2:])
    return 0, pw, 0, ph


def max_pool_same(x: torch.Tensor, stride: int) -> torch.Tensor:
    """flax ``max_pool(x, (2, 2), (stride, stride), padding="SAME")`` on an
    NCHW tensor: the pad is -inf (``_pool_pads``); ``MaxPool2d``'s padding
    is symmetric.  NaN propagates."""
    pads = _pool_pads(x, stride)
    if any(pads):
        x = F.pad(x, pads, value=float("-inf"))
    return F.max_pool2d(x, 2, stride)


def smooth_max_pool_same(x: torch.Tensor, stride: int) -> torch.Tensor:
    """log-sum-exp over each window of ``max_pool_same``, the pad
    contributing exp(-inf) = 0: a smooth max-pool."""
    e = F.pad(torch.exp(x), _pool_pads(x, stride))
    return torch.log(F.avg_pool2d(e, 2, stride) * 4)


def smooth_witness(net: nn.Module, pools: bool = True) -> nn.Module:
    """A copy of ``net`` with a * x + (1 - a) * softplus(x) in place of
    each ConvBN's ReLU, ReLU6 (a = 0) or LeakyReLU(a), and with ``pools``
    tiny_yolo's max-pools by ``smooth_max_pool_same``.  Its gradients are
    well conditioned, where the kinks, and at small grids pool windows
    whose two largest values lie within rounding, send a gradient to
    another element between two programs (on an H100 against the CPU, 1%
    of tiny_yolo's conv_4 kernel gradient): a check of gradients across
    devices or frameworks holds this copy to a tight tolerance."""
    net = copy.deepcopy(net)
    for m in net.modules():
        if isinstance(m, ConvBN) and m.act is not None:
            with torch.no_grad():
                a = -float(m.act(torch.tensor([-1.0])))   # slope below 0
            m.act = lambda x, a=a: a * x + (1 - a) * F.softplus(x)
        if pools and hasattr(m, "pool"):
            m.pool = smooth_max_pool_same
    return net


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
    """BatchNorm over channels in fp32, in flax's order:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``.

    In train mode (flax 0.12's ``use_fast_variance``) the statistics are
    the batch's, ``mean = E[x]`` and the biased ``var = max(0, E[x^2] -
    E[x]^2)`` over (N, H, W) in fp32, and each call moves the running ones:
    ``r = m * r + (1 - m) * batch`` with m = ``momentum`` (flax's
    default 0.99; MobileNetV2 uses 0.999).  ``F.batch_norm`` would store
    the unbiased variance, so the statistics are written out here.  In eval
    mode the running statistics normalise."""

    def __init__(self, features: int, momentum: float = 0.99):
        super().__init__()
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean,
                                  0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + _BN_EPS) * self.weight
        y = x - mean[:, None, None]
        if torch.is_grad_enabled():
            return y * mul[:, None, None] + self.bias[:, None, None]
        return y.mul_(mul[:, None, None]).add_(self.bias[:, None, None])


class ConvBN(nn.Module):
    """Bias-free conv (or depthwise conv) -> BN (eps 1e-3) -> activation.

    ``explicit_pad``: ((top, bottom), (left, right)) zero padding before a
    VALID conv, how the reference writes every stride-2 conv; otherwise
    stride-1 convs are SAME and others VALID.  ``bn_momentum`` is the
    BatchNorm's (the JAX ``ConvBN.bn_momentum``, default 0.99)."""

    def __init__(self, cin: int, features: int,
                 kernel: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1),
                 explicit_pad: Optional[Pads] = None,
                 act: Optional[Callable] = None, depthwise: bool = False,
                 bn_momentum: float = 0.99):
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
        self.bn = BatchNorm(cout, bn_momentum)
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

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

With a data-parallel process group set on the net (:func:`set_data_group`,
done by the train step on a mesh), train-mode BatchNorm normalises with the
statistics of the whole global batch, as JAX's one GSPMD program does.

``dtype`` may also be the :class:`Int8Act` sentinel (the JAX package's
serving-only int8-activation modes): then every bias-free dense conv but
the stem computes int8 x int8 -> int32 (``Conv.forward_int8``), and the
stem, the depthwise convs and the biased head convs stay in the sentinel's
``out_dtype``.  A stem in the ``"nativeconv"`` stem mode computes int8 too,
as the JAX dispatch gives it (``ConvBN.stem_mode``).
"""

from __future__ import annotations

import copy
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

__all__ = ["BatchNorm", "Conv", "ConvBN", "DarknetConvBN", "Int8Act",
           "STEM_MODES",
           "darknet_head_conv", "leaky_relu", "max_pool_same", "name_convs",
           "exact_div", "relu", "relu6", "set_data_group",
           "smooth_max_pool_same", "smooth_witness", "split_dtype",
           "upsample2x"]

Pads = Tuple[Tuple[int, int], Tuple[int, int]]

# the JAX package's serving stem variants (``ConvBN.stem_mode``)
STEM_MODES = ("default", "patches", "nativeconv")

_BN_EPS = 1e-3  # keras BatchNormalization's default, as the reference uses


class Int8Act:
    """Compute-dtype sentinel of the JAX package's ``Int8Act``: the dense
    convs run int8 x int8 -> int32 and are rescaled into ``out_dtype``.
    Weights quantize per output channel inside each call; activations per
    tensor, with a zero point (``affine``, default) or one abs-max scale
    (``affine=False``), from the tensor itself or, with ``static``, from
    each conv's calibrated ``act_min`` / ``act_max`` buffers.  With
    ``calibrate`` (and ``static``) a conv records its input's range into
    those buffers, widening them, and returns the unquantized fp32 conv.
    Pass it wherever a builder takes ``dtype``; serving only."""

    def __init__(self, out_dtype: torch.dtype = torch.bfloat16,
                 affine: bool = True, static: bool = False,
                 calibrate: bool = False):
        self.out_dtype = out_dtype
        self.affine = affine
        self.static = static
        self.calibrate = calibrate

    def _key(self):
        return (self.out_dtype, self.affine, self.static, self.calibrate)

    def __hash__(self):
        return hash((Int8Act,) + self._key())

    def __eq__(self, other):
        return isinstance(other, Int8Act) and self._key() == other._key()

    def __repr__(self):
        return (f"Int8Act({self.out_dtype}, affine={self.affine}, "
                f"static={self.static}, calibrate={self.calibrate})")


def exact_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` correctly rounded on every device: CUDA divides by a host
    scalar as a product with its reciprocal (an ulp off, as XLA under
    jit), but by a device tensor exactly."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def split_dtype(dtype):
    """(the float dtype of the wide paths, the Int8Act sentinel or None)."""
    if isinstance(dtype, Int8Act):
        return dtype.out_dtype, dtype
    return dtype, None


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
    loaded state dict fills them.

    A bias-free dense conv of more than 4 input channels also runs int8
    (:meth:`forward_int8`).  Its calibrated activation range, the JAX
    package's ``act_ranges`` collection (``act_ranges/<scope>/min`` and
    ``max``), lives in the buffers ``act_min`` / ``act_max``: not part of
    the state dict, made at zero by the first static call
    (``training.checkpoint.load_act_ranges`` brings JAX's across)."""

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
        self.int8_capable = self.int8_rule("default")
        self.scope = "conv"     # the module path, for error messages

    def int8_rule(self, stem_mode: str) -> bool:
        """Whether this conv computes int8 under Int8Act in ``stem_mode``:
        the JAX dispatch keeps depthwise and biased convs wide, and a stem
        (4 or fewer input channels) too unless it is ``"nativeconv"``."""
        return self.groups == 1 and self.bias is None and (
            self.weight.shape[1] > 4 or stem_mode == "nativeconv")

    def _conv2d(self, x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor]) -> torch.Tensor:
        (top, bottom), (left, right) = self.pads
        if top == bottom and left == right:
            padding = (top, left)
        else:
            x = F.pad(x, (left, right, top, bottom))
            padding = (0, 0)
        return F.conv2d(x, weight, bias, self.strides, padding, 1,
                        self.groups)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(dtype)
        return self._conv2d(x.to(dtype), self.weight.to(dtype), bias)

    def forward_patches(self, x: torch.Tensor,
                        dtype: torch.dtype) -> torch.Tensor:
        """The conv over its im2col patches ``x`` [B, Ho, kh, Wo, kw, C]
        (``ops/letterbox.letterbox_stem_patches``, the padding already in
        them), the JAX ``_StemPatchesConv``: (kh, kw, C) contracted against
        the OIHW ``weight`` in ``dtype``; an NCHW view out."""
        cout, cin, kh, kw = self.weight.shape
        if self.bias is not None or self.groups != 1 or x.ndim != 6 \
                or (x.shape[2], x.shape[4], x.shape[5]) != (kh, kw, cin):
            raise ValueError(
                f"{self.scope}: the patches conv takes [N, Ho, {kh}, Wo, "
                f"{kw}, {cin}] patches into a dense bias-free conv, got "
                f"{tuple(x.shape)}")
        b, ho, _, wo, _, _ = x.shape
        cols = x.to(dtype).permute(0, 1, 3, 2, 4, 5).reshape(
            b * ho * wo, kh * kw * cin)
        k2 = self.weight.to(dtype).permute(0, 2, 3, 1).reshape(cout, -1)
        return (cols @ k2.t()).reshape(b, ho, wo, cout).permute(0, 3, 1, 2)

    def act_ranges(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(act_min, act_max), made at zero on ``device`` if absent."""
        if not hasattr(self, "act_min"):
            with torch.inference_mode(False):
                for name in ("act_min", "act_max"):
                    self.register_buffer(
                        name, torch.zeros((), device=device), persistent=False)
        return self.act_min, self.act_max

    def forward_int8(self, x: torch.Tensor, act: Int8Act) -> torch.Tensor:
        """The JAX ``_Int8Conv`` on an NCHW tensor: per-channel weight
        scale ``sw``, per-tensor activation scale ``sx`` (affine: the zero
        point ``zp`` maps the range's min to -127), the int32 product of
        the quantized tensors, the exact correction ``- zp * sum(kq)`` and
        the fp32 rescale by ``sx * sw``; NHWC inside, an NCHW view out.
        Every padded position reads ``zp`` (0 when symmetric), as JAX's
        zp padding and its zero-padded stride-2 input give."""
        if not self.int8_capable:
            raise ValueError(f"{self.scope}: no int8 path for a biased, "
                             "depthwise or <= 4-channel conv")
        xf = x.to(torch.float32)
        if act.static:
            rmin, rmax = self.act_ranges(x.device)
            if act.calibrate:
                # ranges of the float net's activations, widening; the
                # calibration forward itself runs unquantized
                rmin.copy_(torch.minimum(rmin, torch.amin(xf)))
                rmax.copy_(torch.maximum(rmax, torch.amax(xf)))
                return self._conv2d(xf, self.weight.to(torch.float32),
                                    None).to(act.out_dtype)
            xmin = torch.clamp_max(rmin, 0.0)
            xmax = torch.clamp_min(rmax, 0.0)
        elif act.affine:
            xmin = torch.clamp_max(torch.amin(xf), 0.0)
            xmax = torch.clamp_min(torch.amax(xf), 0.0)
        else:
            amax = torch.amax(xf.abs())
            xmin, xmax = -amax, amax
        (top, bottom), (left, right) = self.pads
        # a padded 0 quantizes to exactly zp (affine) or 0 (symmetric)
        xf = F.pad(xf, (left, right, top, bottom))
        if act.affine:
            sx = exact_div(torch.clamp_min(xmax - xmin, 1e-6), 254.0)
            zp = torch.clamp(-127.0 - torch.round(xmin / sx), -127.0, 127.0)
            xq = torch.clamp(torch.round(xf / sx) + zp, -127.0, 127.0)
        else:
            sx = exact_div(torch.clamp_min(torch.maximum(-xmin, xmax), 1e-6),
                           127.0)
            xq = torch.clamp(torch.round(xf / sx), -127, 127)
        wq, sw, wsum = self.int8_weight()
        y = self._int8_product(xq.to(torch.int8), wq)      # [B, Ho, Wo, O]
        if act.affine:
            y = y - zp.to(torch.int32) * wsum
        y = (y.to(torch.float32) * (sx * sw)).to(act.out_dtype)
        return y.permute(0, 3, 1, 2)

    def int8_weight(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The quantized kernel of :meth:`forward_int8`: (``wq`` [n8, k8]
        int8, row o the kernel of output channel o in (kh, kw, cin) order,
        zero padded to multiples of 8; ``sw`` [O] fp32; ``sum(kq)`` [O]
        int32).  The copy :meth:`hold_int8_weight` keeps, else made from
        ``weight`` on each call."""
        if hasattr(self, "int8_wq"):
            return self.int8_wq, self.int8_sw, self.int8_wsum
        kf = self.weight.to(torch.float32)
        sw = exact_div(torch.clamp_min(torch.amax(kf.abs(), dim=(1, 2, 3)),
                                       1e-12), 127.0)
        kq = torch.clamp(torch.round(kf / sw[:, None, None, None]),
                         -127, 127).to(torch.int8)
        cout, k = kq.shape[0], kq[0].numel()
        wq = F.pad(kq.permute(0, 2, 3, 1).reshape(cout, k),
                   (0, -k % 8, 0, -cout % 8))
        return wq, sw, kq.to(torch.int32).sum(dim=(1, 2, 3))

    def hold_int8_weight(self) -> None:
        """Keep :meth:`int8_weight` as buffers, for a net whose weights no
        longer change (a Predictor's): each call then skips quantizing the
        kernel."""
        for name, t in zip(("int8_wq", "int8_sw", "int8_wsum"),
                           self.int8_weight()):
            self.register_buffer(name, t, persistent=False)

    def _int8_product(self, xq: torch.Tensor, wq: torch.Tensor
                      ) -> torch.Tensor:
        """Padded int8 NCHW input and :meth:`int8_weight`'s ``wq`` -> the
        VALID conv's int32 [B, Ho, Wo, O]: one ``torch._int_mm`` over an
        im2col built from the kh * kw shifted slices (``F.unfold`` has no
        int8), columns in (kh, kw, cin) order.  ``_int_mm`` on a CUDA
        tensor (cuBLASLt) takes more than 16 rows and k, n multiples of 8:
        the columns are zero padded to ``wq``'s k, the rows to 17 where
        fewer, and the result cut back; zeros leave an integer product
        exactly as it was."""
        cout, cin, kh, kw = self.weight.shape
        sh, sw = self.strides
        x = xq.permute(0, 2, 3, 1)                          # NHWC
        b, hp, wp, _ = x.shape
        ho, wo = (hp - kh) // sh + 1, (wp - kw) // sw + 1
        if (kh, kw, sh, sw) == (1, 1, 1, 1):
            cols = x.reshape(b * ho * wo, cin)
        else:
            cols = torch.stack([x[:, i:i + sh * (ho - 1) + 1:sh,
                                  j:j + sw * (wo - 1) + 1:sw]
                                for i in range(kh) for j in range(kw)], 3)
            cols = cols.reshape(b * ho * wo, kh * kw * cin)
        m, k = cols.shape
        if m <= 16 or k != wq.shape[1]:
            cols = F.pad(cols, (0, wq.shape[1] - k, 0, max(17 - m, 0)))
        y = torch._int_mm(cols.contiguous(), wq.t())
        return y[:m, :cout].reshape(b, ho, wo, cout)


def name_convs(net: nn.Module) -> nn.Module:
    """Set each :class:`Conv`'s ``scope`` to its module path."""
    for name, mod in net.named_modules():
        if isinstance(mod, Conv):
            mod.scope = name
    return net


class _AllReduceSum(torch.autograd.Function):
    """A sum over a process group whose backward sums the incoming gradient
    over the same group: every rank's output is used by every rank's
    loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class BatchNorm(nn.Module):
    """BatchNorm over channels in fp32, in flax's order:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``.

    In train mode (flax 0.12's ``use_fast_variance``) the statistics are
    the batch's, ``mean = E[x]`` and the biased ``var = max(0, E[x^2] -
    E[x]^2)`` over (N, H, W) in fp32, and each call moves the running ones:
    ``r = m * r + (1 - m) * batch`` with m = ``momentum`` (flax's
    default 0.99; MobileNetV2 uses 0.999).  ``F.batch_norm`` would store
    the unbiased variance, so the statistics are written out here.  In eval
    mode the running statistics normalise.

    With ``data_group`` set (a process group over ranks holding equal
    shards of one batch), the batch is the global one: each rank's
    ``E[x]`` and ``E[x^2]``, weighted by its share 1 / dp, are summed over
    the group by a sum whose backward sums the gradient too, so the
    statistics, the running ones and the gradients are the whole batch's.
    At dp = 1 that is this arithmetic exactly (a product by 1.0)."""

    def __init__(self, features: int, momentum: float = 0.99):
        super().__init__()
        self.momentum = momentum
        self.data_group = None
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            sq = (x * x).mean(dim=(0, 2, 3))
            if self.data_group is not None:
                share = 1.0 / dist.get_world_size(self.data_group)
                mean, sq = _AllReduceSum.apply(
                    torch.stack([mean, sq]) * share,
                    self.data_group).unbind(0)
            var = torch.clamp_min(sq - mean * mean, 0.0)
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


def set_data_group(net: nn.Module, group) -> nn.Module:
    """Set (a process group) or clear (None) the data-parallel group of
    every :class:`BatchNorm` in ``net``; returns ``net``."""
    for mod in net.modules():
        if isinstance(mod, BatchNorm):
            mod.data_group = group
    return net


class ConvBN(nn.Module):
    """Bias-free conv (or depthwise conv) -> BN (eps 1e-3) -> activation.

    ``explicit_pad``: ((top, bottom), (left, right)) zero padding before a
    VALID conv, how the reference writes every stride-2 conv; otherwise
    stride-1 convs are SAME and others VALID.  ``bn_momentum`` is the
    BatchNorm's (the JAX ``ConvBN.bn_momentum``, default 0.99).

    ``stem_mode`` (one of ``STEM_MODES``, settable) is the JAX package's
    serving stem variant:

    * ``"default"``: the conv on the image (cuDNN through ``F.conv2d``);
    * ``"patches"``: the input is already the conv's im2col patches from
      ``ops/letterbox.letterbox_stem_patches``, padding included
      (``Conv.forward_patches``), float dtypes only;
    * ``"nativeconv"``: the same conv as ``"default"``, but under Int8Act a
      stem of 4 or fewer input channels computes int8 like every other
      dense conv (the JAX dispatch skips its wide-stem branch in this mode),
      and holds an activation range in the calibrated mode.

    JAX's own ``"default"`` stem (``_StemConv``, im2col and a matmul) and
    its trace-time choice of ``nn.Conv`` are TPU dispatch workarounds: the
    same function in another summation order, which ``F.conv2d`` computes.
    """

    def __init__(self, cin: int, features: int,
                 kernel: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1),
                 explicit_pad: Optional[Pads] = None,
                 act: Optional[Callable] = None, depthwise: bool = False,
                 bn_momentum: float = 0.99, stem_mode: str = "default"):
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
        self.stem_mode = stem_mode

    @property
    def stem_mode(self) -> str:
        return self._stem_mode

    @stem_mode.setter
    def stem_mode(self, mode: str) -> None:
        if mode not in STEM_MODES:
            raise ValueError(f"unknown stem_mode {mode!r}")
        self._stem_mode = mode
        self.conv.int8_capable = self.conv.int8_rule(mode)

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32,
                post_conv_scale: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        dtype, int8_act = split_dtype(dtype)
        if int8_act is not None and self.training:
            # round() has no gradient: the conv stack would not train
            raise NotImplementedError(
                "Int8Act is a serving-only compute mode; build the training "
                "net with a float dtype (train with bf16/fp32, serve with "
                "quantize='int8_act')")
        if self.stem_mode == "patches":
            if int8_act is not None:
                raise ValueError("stem_mode='patches' has no int8-activation "
                                 "path")
            x = self.conv.forward_patches(x, dtype)
        elif int8_act is not None and self.conv.int8_capable:
            x = self.conv.forward_int8(x, int8_act)
        else:
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
    variant pads top/left only.  ``stem_mode`` as ``ConvBN``'s (these stems
    are stride 1: ``"patches"`` is refused by the Predictor)."""

    def __init__(self, cin: int, features: int,
                 kernel: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1),
                 stem_mode: str = "default"):
        super().__init__()
        explicit = ((1, 0), (1, 0)) if tuple(strides) == (2, 2) else None
        self.dark_conv_bn = ConvBN(cin, features, kernel, strides,
                                   explicit_pad=explicit,
                                   act=leaky_relu(0.1), stem_mode=stem_mode)

    @property
    def stem_mode(self) -> str:
        return self.dark_conv_bn.stem_mode

    @stem_mode.setter
    def stem_mode(self, mode: str) -> None:
        self.dark_conv_bn.stem_mode = mode

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
        # under Int8Act the head conv stays wide: its output is the decode
        # surface
        return self.dark_conv_out(x, split_dtype(dtype)[0])

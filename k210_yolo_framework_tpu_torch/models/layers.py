"""Conv building blocks as ``nn.Module``s, for serving and training.

Counterpart of ``k210_yolo_framework_tpu/models/layers.py`` (``ConvBN``,
``DarknetConvBN``, ``darknet_head_conv``, ``leaky_relu``, ``relu6``,
``upsample2x``) and of flax's 2x2 ``max_pool(..., padding="SAME")``
(``max_pool_same``); ``smooth_witness`` smooths those kinks for checks
of gradients.  ``mish`` and ``spp`` serve YOLOv4
(``models/cspdarknet.py``), which the JAX package does not build.  Inside
the net tensors are NCHW; the public entry points (``models/yolonet.py``)
take and return NHWC, as the JAX package does.

Where the rounding happens follows flax: each conv casts its input and its
weights to the compute ``dtype`` and returns that dtype; BatchNorm runs in
fp32 (eps 1e-3, momentum per module: 0.99 unless a builder says
otherwise) and so do the activations.  ``module.train()`` puts
BatchNorm on batch statistics (flax's ``train=True``), ``.eval()`` on the
running ones.  In eval mode under ``torch.no_grad()`` / ``inference_mode``
a ``ConvBN`` runs its post-conv scale, BN, activation and residual add as
one pass (``ops.conv_epilogue``: one kernel on a card), and may store in
the compute dtype where its owner says every consumer casts to it
(``ConvBN.forward``); with gradients on they are out of place, as
autograd needs.
Parameter names follow the flax scopes (``conv.weight`` for ``conv/kernel``,
``bn.weight`` for ``bn/scale``), so ``training/checkpoint.py`` maps a native
checkpoint mechanically.

With a data-parallel process group set on the net (:func:`set_data_group`,
done by the train step on a mesh), train-mode BatchNorm normalises with the
statistics of the whole global batch, as JAX's one GSPMD program does.
On a mesh with a model or space axis the layers take and return
``parallel.sharded.Sharded`` activations instead (this rank's channels and
rows of each, ``parallel/sharded.py``): ``Conv``, ``ConvBN``,
``DarknetConvBN``, ``darknet_head_conv``, ``upsample2x``,
``cat_channels``, ``residual_add``, ``max_pool_same`` and
``smooth_max_pool_same`` accept either, and so do the int8 conv and the
patches stem below.

``dtype`` may also be the :class:`Int8Act` sentinel (the JAX package's
serving-only int8-activation modes): then every bias-free dense conv but
the stem computes int8 x int8 -> int32 (``Conv.forward_int8``), and the
stem, the depthwise convs and the biased head convs stay in the sentinel's
``out_dtype``.  A stem in the ``"nativeconv"`` stem mode computes int8 too,
as the JAX dispatch gives it (``ConvBN.stem_mode``).  On a TP/SP mesh a
dynamic range is the whole global tensor's, as in JAX's one GSPMD program
(``parallel.sharded.tensor_range``).
"""

from __future__ import annotations

import copy
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from k210_yolo_framework_tpu_torch.ops.conv_epilogue import conv_epilogue
from k210_yolo_framework_tpu_torch.parallel.sharded import (
    Sharded,
    all_reduce_sum,
    conv_rows,
    gather,
    tensor_range,
)
from k210_yolo_framework_tpu_torch.parallel.sharded import add as _add_sharded
from k210_yolo_framework_tpu_torch.parallel.sharded import (
    cat_channels as _cat_sharded,
)

__all__ = ["BatchNorm", "Conv", "ConvBN", "DarknetConvBN", "Int8Act",
           "STEM_MODES", "cat_channels",
           "darknet_head_conv", "leaky_relu", "max_pool_same", "name_convs",
           "exact_div", "mish", "relu", "relu6", "residual_add",
           "set_data_group", "smooth_max_pool_same", "smooth_witness",
           "split_dtype", "spp", "upsample2x"]

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

    act.leaky_alpha = alpha     # what ``ConvBN``'s fused epilogue reads
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


def mish(x: torch.Tensor) -> torch.Tensor:
    """Mish, ``x * tanh(softplus(x))`` (YOLOv4's trunk activation; smooth,
    so ``smooth_witness`` keeps it); in place without gradients."""
    return F.mish(x, inplace=not torch.is_grad_enabled())


def spp(x: torch.Tensor) -> torch.Tensor:
    """YOLOv4's spatial pyramid pooling on an NCHW tensor:
    ``[maxpool13(x), maxpool9(x), maxpool5(x), x]`` on channels, each pool
    stride 1 with its window centred and -inf past the map (darknet's
    stride-1 ``[maxpool]``).  The 9 and 13 windows are two and three 5x5
    pools in a row, which take the same maxima."""
    # max_pool2d's padding is -inf
    p5 = F.max_pool2d(x, 5, 1, 2)
    p9 = F.max_pool2d(p5, 5, 1, 2)
    return torch.cat([F.max_pool2d(p9, 5, 1, 2), p9, p5, x], dim=1)


def upsample2x(x):
    """Nearest-neighbour 2x upsample of an NCHW tensor (keras
    ``UpSampling2D(2)``), or of a ``Sharded`` one: a rank's rows s of H
    become its rows of 2H, its channels stay its own."""
    if isinstance(x, Sharded):
        return x.like(upsample2x(x.t))
    return F.interpolate(x, scale_factor=2, mode="nearest")


def cat_channels(parts):
    """NCHW tensors concatenated on channels, in order (``torch.cat`` on
    dim 1), or ``Sharded`` ones (``parallel.sharded.cat_channels``)."""
    if isinstance(parts[0], Sharded):
        return _cat_sharded(parts)
    return torch.cat(parts, dim=1)


def residual_add(fresh, other):
    """``fresh + other``, a residual add: without gradients written into
    ``fresh`` (the caller's fresh conv output), never into ``other`` (it
    may be a tap the caller keeps); ``Sharded`` ones through
    ``parallel.sharded.add``."""
    if isinstance(fresh, Sharded):
        return _add_sharded(fresh, other)
    return fresh + other if torch.is_grad_enabled() else fresh.add_(other)


def _pool_pad(n: int, stride: int) -> int:
    """XLA's SAME pad of a 2x2 window at ``stride`` over ``n`` pixels: at
    most one, after (stride 1: one; stride 2: where ``n`` is odd)."""
    return max((-(-n // stride) - 1) * stride + 2 - n, 0)


def _pool_pads(x: torch.Tensor, stride: int) -> Tuple[int, int, int, int]:
    """``F.pad``'s (left, right, top, bottom) for XLA's SAME 2x2 window on
    an NCHW tensor (``_pool_pad`` of each side)."""
    ph, pw = (_pool_pad(n, stride) for n in x.shape[-2:])
    return 0, pw, 0, ph


def _pool_sharded(x: Sharded, stride: int, window) -> Sharded:
    """This rank's part of a 2x2 SAME pool on a TP/SP mesh: its channels
    as they come; its output rows where they divide by sp
    (``parallel.sharded.conv_rows``: no halo at stride 2, one row of the
    next space rank below at stride 1 and -inf past the last), else the
    rows gathered and pooled whole.  W is never split, so the right-hand
    -inf column is local.  ``window(t, stride)`` pools the -inf padded
    rows."""
    inf = float("-inf")
    h = x.t.shape[2] * (x.ctx.sp if x.rows else 1)
    t, (top, bottom), rows = conv_rows(x, x.t, 2, stride,
                                       (0, _pool_pad(h, stride)), fill=inf)
    pw = _pool_pad(t.shape[3], stride)
    if top or bottom or pw:
        t = F.pad(t, (0, pw, top, bottom), value=inf)
    return Sharded(window(t, stride), x.ctx, rows, x.channels)


def _max_window(t: torch.Tensor, stride: int) -> torch.Tensor:
    return F.max_pool2d(t, 2, stride)


def _smooth_window(t: torch.Tensor, stride: int) -> torch.Tensor:
    # exp(-inf) = 0: the pad adds nothing to a window's sum
    return torch.log(F.avg_pool2d(torch.exp(t), 2, stride) * 4)


def _pool_same(x, stride: int, window):
    """``window`` over XLA's SAME 2x2 windows of an NCHW tensor, the pad
    -inf (``_pool_pads``), or of a ``Sharded`` one (``_pool_sharded``)."""
    if isinstance(x, Sharded):
        return _pool_sharded(x, stride, window)
    pads = _pool_pads(x, stride)
    if any(pads):
        x = F.pad(x, pads, value=float("-inf"))
    return window(x, stride)


def max_pool_same(x, stride: int):
    """flax ``max_pool(x, (2, 2), (stride, stride), padding="SAME")`` on an
    NCHW tensor or a ``Sharded`` one: the pad is -inf; ``MaxPool2d``'s
    padding is symmetric.  NaN propagates."""
    return _pool_same(x, stride, _max_window)


def smooth_max_pool_same(x, stride: int):
    """log-sum-exp over each window of ``max_pool_same``, the pad
    contributing exp(-inf) = 0: a smooth max-pool."""
    return _pool_same(x, stride, _smooth_window)


def smooth_witness(net: nn.Module, pools: bool = True) -> nn.Module:
    """A copy of ``net`` with a * x + (1 - a) * softplus(x) in place of
    each ConvBN's ReLU, ReLU6 (a = 0) or LeakyReLU(a) (Mish, which has no
    kink, is kept), and with ``pools`` tiny_yolo's max-pools by
    ``smooth_max_pool_same``.  Its gradients are
    well conditioned, where the kinks, and at small grids pool windows
    whose two largest values lie within rounding, send a gradient to
    another element between two programs (on an H100 against the CPU, 1%
    of tiny_yolo's conv_4 kernel gradient): a check of gradients across
    devices or frameworks holds this copy to a tight tolerance."""
    net = copy.deepcopy(net)
    for m in net.modules():
        if isinstance(m, ConvBN) and m.act not in (None, mish):
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

    def forward(self, x, dtype: torch.dtype):
        if isinstance(x, Sharded):
            return self.forward_sharded(x, dtype)
        bias = None if self.bias is None else self.bias.to(dtype)
        return self._conv2d(x.to(dtype), self.weight.to(dtype), bias)

    def forward_sharded(self, x: Sharded, dtype: torch.dtype) -> Sharded:
        """This rank's part of the conv on a TP/SP mesh
        (``parallel/sharded.py``): output channels ``channel_range`` of the
        kernel from ``weight[lo:hi]`` (and ``bias[lo:hi]``); the input's
        channels gathered for a dense conv, that slice of them for a
        depthwise one; this rank's output rows where they divide by sp
        (``conv_rows``)."""
        ctx = x.ctx
        cout, _, kh, _ = self.weight.shape
        lo, hi = ctx.channel_range(cout)
        sliced = hi - lo < cout
        t = x.t.to(dtype)
        t = x.channel_slice(t, lo, hi) if self.groups > 1 and sliced \
            else x.whole_channels(t)
        t, (top, bottom), rows = conv_rows(x, t, kh, self.strides[0],
                                           self.pads[0])
        left, right = self.pads[1]
        if top or bottom or left or right:
            t = F.pad(t, (left, right, top, bottom))
        weight, bias = self.weight[lo:hi], self.bias
        if bias is not None:
            bias = bias[lo:hi].to(dtype)
        y = F.conv2d(t, weight.to(dtype), bias, self.strides, 0, 1,
                     1 if self.groups == 1 else hi - lo)
        return Sharded(y, ctx, rows, sliced)

    def forward_patches(self, x, dtype: torch.dtype):
        """The conv over its im2col patches ``x`` [B, Ho, kh, Wo, kw, C]
        (``ops/letterbox.letterbox_stem_patches``, the padding already in
        them), the JAX ``_StemPatchesConv``: (kh, kw, C) contracted against
        the OIHW ``weight`` in ``dtype``; an NCHW view out.  A ``Sharded``
        ``x`` (the whole patches on every rank of a TP/SP mesh) gives this
        rank's part: output rows ``row_range(Ho)`` from those rows of the
        patches (they carry their own padding: no halo; every row where Ho
        does not divide by sp) and output channels ``channel_range`` from
        ``weight[lo:hi]``."""
        p = x.t if isinstance(x, Sharded) else x
        cout, cin, kh, kw = self.weight.shape
        if self.bias is not None or self.groups != 1 or p.ndim != 6 \
                or (p.shape[2], p.shape[4], p.shape[5]) != (kh, kw, cin) \
                or (isinstance(x, Sharded) and (x.rows or x.channels)):
            raise ValueError(
                f"{self.scope}: the patches conv takes [N, Ho, {kh}, Wo, "
                f"{kw}, {cin}] patches, whole on every rank, into a dense "
                f"bias-free conv, got {tuple(p.shape)}")
        weight = self.weight
        if isinstance(x, Sharded):
            lo, hi = x.ctx.channel_range(cout)
            rlo, rhi = x.ctx.row_range(p.shape[1])
            p, weight = p[:, rlo:rhi], weight[lo:hi]
        b, ho, _, wo, _, _ = p.shape
        cols = p.to(dtype).permute(0, 1, 3, 2, 4, 5).reshape(
            b * ho * wo, kh * kw * cin)
        k2 = weight.to(dtype).permute(0, 2, 3, 1).reshape(len(weight), -1)
        y = (cols @ k2.t()).reshape(b, ho, wo, -1).permute(0, 3, 1, 2)
        if isinstance(x, Sharded):
            return Sharded(y, x.ctx, rhi - rlo < x.t.shape[1], hi - lo < cout)
        return y

    def act_ranges(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(act_min, act_max), made at zero on ``device`` if absent."""
        if not hasattr(self, "act_min"):
            with torch.inference_mode(False):
                for name in ("act_min", "act_max"):
                    self.register_buffer(
                        name, torch.zeros((), device=device), persistent=False)
        return self.act_min, self.act_max

    def forward_int8(self, x, act: Int8Act):
        """The JAX ``_Int8Conv`` on an NCHW tensor: per-channel weight
        scale ``sw``, per-tensor activation scale ``sx`` (affine: the zero
        point ``zp`` maps the range's min to -127), the int32 product of
        the quantized tensors, the exact correction ``- zp * sum(kq)`` and
        the fp32 rescale by ``sx * sw``; NHWC inside, an NCHW view out.
        Every padded position reads ``zp`` (0 when symmetric), as JAX's
        zp padding and its zero-padded stride-2 input give.  A ``Sharded``
        input gives this rank's part (:meth:`_forward_int8_sharded`)."""
        if not self.int8_capable:
            raise ValueError(f"{self.scope}: no int8 path for a biased, "
                             "depthwise or <= 4-channel conv")
        if isinstance(x, Sharded):
            return self._forward_int8_sharded(x, act)
        xf = x.to(torch.float32)
        if act.static and act.calibrate:
            rmin, rmax = self.act_ranges(x.device)
            # ranges of the float net's activations, widening; the
            # calibration forward itself runs unquantized
            rmin.copy_(torch.minimum(rmin, torch.amin(xf)))
            rmax.copy_(torch.maximum(rmax, torch.amax(xf)))
            return self._conv2d(xf, self.weight.to(torch.float32),
                                None).to(act.out_dtype)
        xmin, xmax = self.int8_range(xf, act)
        (top, bottom), (left, right) = self.pads
        return self._int8_conv(xf, (left, right, top, bottom), xmin, xmax,
                               act, *self.int8_weight())

    def int8_range(self, xf: torch.Tensor, act: Int8Act, group=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The range :meth:`forward_int8` quantizes ``xf`` (fp32) with,
        ``(xmin, xmax)`` with ``xmin <= 0 <= xmax`` (so a padded 0 leaves it
        as it is): the calibrated ``act_min`` / ``act_max`` where
        ``act.static``, else the range of the whole tensor ``xf`` is the
        part of over ``group`` (``parallel.sharded.tensor_range``; None:
        ``xf`` itself), symmetric about 0 unless ``act.affine``."""
        if act.static:
            rmin, rmax = self.act_ranges(xf.device)
            return torch.clamp_max(rmin, 0.0), torch.clamp_min(rmax, 0.0)
        if act.affine:
            xmin, xmax = tensor_range(xf, group)
            return torch.clamp_max(xmin, 0.0), torch.clamp_min(xmax, 0.0)
        amax = tensor_range(xf, group, affine=False)
        return -amax, amax

    def _forward_int8_sharded(self, x: Sharded, act: Int8Act) -> Sharded:
        """This rank's part of :meth:`forward_int8` on a TP/SP mesh: the
        input's channels gathered (a dense conv reads them all); its range
        the whole global tensor's, over ``ctx.batch_group(x.rows)`` (data x
        space while the rows are split, data after: the group BatchNorm
        sums over), or the calibrated one; this rank's output rows
        (``conv_rows``: the halo's zeros past the image's edges, like the
        conv's remaining padding, quantize to exactly ``zp``); and output
        channels ``channel_range`` from rows [lo:hi] of the quantized
        kernel, zero padded again to a multiple of 8 (``_int_mm``'s n).
        Gathered, it is :meth:`forward_int8` of the whole tensor bit for
        bit: the range is exact, the halo copies values and the int32 sums
        are exact in any order."""
        if act.calibrate:
            raise ValueError(
                f"{self.scope}: calibration records ranges on one process "
                "(Predictor.calibrate); a sharded forward serves them")
        ctx = x.ctx
        cout, kh = self.weight.shape[0], self.weight.shape[2]
        lo, hi = ctx.channel_range(cout)
        xf = x.whole_channels(x.t.to(torch.float32))
        xmin, xmax = self.int8_range(xf, act, ctx.batch_group(x.rows))
        xf, (top, bottom), rows = conv_rows(x, xf, kh, self.strides[0],
                                            self.pads[0])
        left, right = self.pads[1]
        wq, sw, wsum = self.int8_weight()
        if hi - lo < cout:
            wq = F.pad(wq[lo:hi], (0, 0, 0, -(hi - lo) % 8))
            sw, wsum = sw[lo:hi], wsum[lo:hi]
        y = self._int8_conv(xf, (left, right, top, bottom), xmin, xmax, act,
                            wq, sw, wsum)
        return Sharded(y, ctx, rows, hi - lo < cout)

    def _int8_conv(self, xf: torch.Tensor, pads, xmin: torch.Tensor,
                   xmax: torch.Tensor, act: Int8Act, wq: torch.Tensor,
                   sw: torch.Tensor, wsum: torch.Tensor) -> torch.Tensor:
        """The quantize, product and rescale steps of :meth:`forward_int8`:
        fp32 NCHW rows ``xf``, ``F.pad``'s ``pads`` still to apply, the
        range, and the quantized kernel's rows of the output channels
        computed (``wq`` [n8, k8], ``sw`` and ``sum(kq)`` [n])."""
        # a padded 0 quantizes to exactly zp (affine) or 0 (symmetric)
        xf = F.pad(xf, pads)
        if act.affine:
            sx = exact_div(torch.clamp_min(xmax - xmin, 1e-6), 254.0)
            zp = torch.clamp(-127.0 - torch.round(xmin / sx), -127.0, 127.0)
            xq = torch.clamp(torch.round(xf / sx) + zp, -127.0, 127.0)
        else:
            sx = exact_div(torch.clamp_min(torch.maximum(-xmin, xmax), 1e-6),
                           127.0)
            xq = torch.clamp(torch.round(xf / sx), -127, 127)
        y = self._int8_product(xq.to(torch.int8), wq,
                               len(sw))                    # [B, Ho, Wo, n]
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

    def _int8_product(self, xq: torch.Tensor, wq: torch.Tensor,
                      cout: Optional[int] = None) -> torch.Tensor:
        """Padded int8 NCHW input and :meth:`int8_weight`'s ``wq`` -> the
        VALID conv's int32 [B, Ho, Wo, cout] (``cout``: every output
        channel, or the count of a slice's rows ``wq`` holds): one
        ``torch._int_mm`` over an im2col built from the kh * kw shifted
        slices (``F.unfold`` has no int8), columns in (kh, kw, cin) order.
        ``_int_mm`` on a CUDA tensor (cuBLASLt) takes more than 16 rows and
        k, n multiples of 8: the columns are zero padded to ``wq``'s k, the
        rows to 17 where fewer, and the result cut back; zeros leave an
        integer product exactly as it was."""
        _, cin, kh, kw = self.weight.shape
        cout = self.weight.shape[0] if cout is None else cout
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
    At dp = 1 that is this arithmetic exactly (a product by 1.0).

    On a TP/SP mesh ``layout`` is the ``Sharded`` activation ``x`` is the
    part of: the group is ``layout.ctx.batch_group(layout.rows)`` (data x
    space while the rows are split, data after), and where ``x`` holds the
    channel slice [lo, hi) of a model rank, the parameters and statistics
    of those channels normalise it; the slices' new running statistics
    are gathered over ``model``, so every rank stores them whole."""

    def __init__(self, features: int, momentum: float = 0.99):
        super().__init__()
        self.momentum = momentum
        self.data_group = None
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor,
                layout: Optional[Sharded] = None) -> torch.Tensor:
        x = x.to(torch.float32)
        group, model_group = self.data_group, None
        weight, bias = self.weight, self.bias
        running = self.running_mean, self.running_var
        if layout is not None:
            group = layout.ctx.batch_group(layout.rows)
            if layout.channels:
                lo, hi = layout.ctx.channel_range(self.weight.shape[0])
                model_group = layout.ctx.model_group
                weight, bias = weight[lo:hi], bias[lo:hi]
                running = tuple(r[lo:hi] for r in running)
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            sq = (x * x).mean(dim=(0, 2, 3))
            if group is not None:
                share = 1.0 / dist.get_world_size(group)
                mean, sq = all_reduce_sum(torch.stack([mean, sq]) * share,
                                          group).unbind(0)
            var = torch.clamp_min(sq - mean * mean, 0.0)
            with torch.no_grad():
                new_mean, new_var = mean, var
                if model_group is not None:      # every channel's, whole
                    new_mean, new_var = gather(torch.stack([mean, var]),
                                               model_group, 1)
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * new_mean)
                self.running_var.copy_(m * self.running_var
                                       + (1 - m) * new_var)
        else:
            mean, var = running
        mul = _bn_mul(var, weight)
        y = x - mean[:, None, None]
        if torch.is_grad_enabled():
            return y * mul[:, None, None] + bias[:, None, None]
        return y.mul_(mul[:, None, None]).add_(bias[:, None, None])

    def eval_terms(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(mean, mul, bias) of the eval-mode forward, ``(x - mean) * mul +
        bias``: the running mean, ``rsqrt(running_var + eps) * weight`` (as
        :meth:`forward` computes it) and the shift."""
        return (self.running_mean, _bn_mul(self.running_var, self.weight),
                self.bias)


def _bn_mul(var: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return torch.rsqrt(var + _BN_EPS) * weight


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

    ``wide``: the eval output is an addend of a later fp32 residual sum, and
    the block that makes the sum marks it; :meth:`forward`'s fused pass then
    stores it in fp32.  Every other ConvBN's output reaches convs only, each
    of which casts it to the compute dtype first: it is stored in that dtype.
    """

    def __init__(self, cin: int, features: int,
                 kernel: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1),
                 explicit_pad: Optional[Pads] = None,
                 act: Optional[Callable] = None, depthwise: bool = False,
                 bn_momentum: float = 0.99, stem_mode: str = "default",
                 wide: bool = False):
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
        self.wide = wide

    @property
    def stem_mode(self) -> str:
        return self._stem_mode

    @stem_mode.setter
    def stem_mode(self, mode: str) -> None:
        if mode not in STEM_MODES:
            raise ValueError(f"unknown stem_mode {mode!r}")
        self._stem_mode = mode
        self.conv.int8_capable = self.conv.int8_rule(mode)

    def forward(self, x, dtype: torch.dtype = torch.float32,
                post_conv_scale: Optional[torch.Tensor] = None,
                residual=None):
        """``x`` NCHW, or ``Sharded`` on a TP/SP mesh: then this rank's
        part of the conv (``Conv.forward_sharded``, ``forward_int8`` or
        ``forward_patches``), and the scale, BN and activation on it.
        ``residual`` (like the output) is added after the activation
        (:func:`residual_add`).

        In eval mode with no gradient recorded, outside ``torch.compile``
        and ``torch.export``, on a tensor that is not ``Sharded`` and with
        no activation but ReLU, ReLU6, LeakyReLU or Mish, the scale, BN,
        activation and residual add run as one pass
        (``ops.conv_epilogue``), bit for bit the steps they replace (Mish:
        within rounding, ``conv_epilogue``'s docstring).  It
        stores in fp32, as the other path returns, where ``wide`` is set
        or under Int8Act (the int8 convs quantize from fp32); in the
        compute dtype otherwise.  There a ``residual`` must be fp32."""
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
            y = self.conv.forward_patches(x, dtype)
        elif int8_act is not None and self.conv.int8_capable:
            y = self.conv.forward_int8(x, int8_act)
        else:
            y = self.conv(x, dtype)
        act = _epilogue_act(self.act)
        if act is not None and not isinstance(y, Sharded) \
                and not self.bn.training and not torch.is_grad_enabled() \
                and not torch.compiler.is_compiling():
            if residual is not None and residual.dtype != torch.float32:
                raise ValueError(f"a {residual.dtype} residual: the skip's "
                                 "producer lacks wide=True")
            store = torch.float32 if self.wide or int8_act else dtype
            return conv_epilogue(y, *self.bn.eval_terms(), *act,
                                 scale=post_conv_scale, residual=residual,
                                 store=store)
        layout = y if isinstance(y, Sharded) else None
        t = y if layout is None else y.t
        if post_conv_scale is not None:
            # per-image scalar folded in after the conv: conv(x * s) ==
            # conv(x) * s, so raw 0..255 pixels can go in and the
            # reference's per-image /max normalisation happens here (the
            # identity needs the bias-free conv).  The scale is cast to the
            # conv output's dtype first, as in flax.
            t = t * post_conv_scale.to(t.dtype)[:, None, None, None]
        t = self.bn(t, layout)
        if self.act is not None:
            t = self.act(t)
        out = t if layout is None else layout.like(t)
        return out if residual is None else residual_add(out, residual)


def _epilogue_act(act) -> Optional[Tuple[str, float]]:
    """``(kind, alpha)`` of ``ops.conv_epilogue`` for a ConvBN's activation,
    or None for one it does not compute (``smooth_witness``'s)."""
    if act is None:
        return "none", 0.0
    if act is relu:
        return "relu", 0.0
    if act is relu6:
        return "relu6", 0.0
    if act is mish:
        return "mish", 0.0
    alpha = getattr(act, "leaky_alpha", None)
    return None if alpha is None else ("leaky_relu", alpha)


class DarknetConvBN(nn.Module):
    """``DarknetConv2D_BN_Leaky``: no bias, BN, LeakyReLU 0.1 (or ``act``:
    YOLOv4's trunk passes :func:`mish`); the stride-2 variant pads top/left
    only.  ``stem_mode`` and ``wide`` as ``ConvBN``'s (these stems are
    stride 1: ``"patches"`` is refused by the Predictor)."""

    def __init__(self, cin: int, features: int,
                 kernel: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1),
                 stem_mode: str = "default", act: Optional[Callable] = None,
                 wide: bool = False):
        super().__init__()
        explicit = ((1, 0), (1, 0)) if tuple(strides) == (2, 2) else None
        self.dark_conv_bn = ConvBN(cin, features, kernel, strides,
                                   explicit_pad=explicit,
                                   act=act or leaky_relu(0.1),
                                   stem_mode=stem_mode, wide=wide)

    @property
    def stem_mode(self) -> str:
        return self.dark_conv_bn.stem_mode

    @stem_mode.setter
    def stem_mode(self, mode: str) -> None:
        self.dark_conv_bn.stem_mode = mode

    def forward(self, x, dtype: torch.dtype = torch.float32,
                post_conv_scale: Optional[torch.Tensor] = None,
                residual=None):
        return self.dark_conv_bn(x, dtype, post_conv_scale, residual)


class darknet_head_conv(nn.Module):  # noqa: N801 (the JAX package's name)
    """Final 1x1 ``DarknetConv2D`` with bias, no BN or activation."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.dark_conv_out = Conv(cin, features, (1, 1), use_bias=True)

    def forward(self, x, dtype: torch.dtype = torch.float32):
        # under Int8Act the head conv stays wide: its output is the decode
        # surface
        return self.dark_conv_out(x, split_dtype(dtype)[0])

"""The model and space axes: the collectives of a TP/SP forward, and the
activation that carries how it is cut.

On a mesh with a ``model`` (channel tensor parallelism) or ``space`` (H-row
spatial partitioning) axis, JAX runs one GSPMD program and XLA writes the
collectives (``k210_yolo_framework_tpu/parallel/mesh.py``); the JAX package
has no module like this one.  Here each process, one a device, computes
what that program computes for its mesh coordinate:

  * a conv whose kernel ``parallel.mesh.param_shardings`` marks computes
    only its rank's output channels (``mesh.channel_range``) from
    ``weight[lo:hi]``; a depthwise conv reads the same slice of its input
    (no collective where the input already is that slice), a dense conv
    the whole input, gathered over ``model`` (:func:`gather`) where it
    came as a slice; BatchNorm and the activation run on the slice;
  * a conv whose output rows divide by sp computes rank s's rows
    (``mesh.row_range``): a split input first takes the rows its window
    reaches beyond its own from the neighbouring space ranks
    (:func:`halo`, zeros past the image's top and bottom edge, where the
    conv's own padding is), a replicated input has them and is cut
    locally; where the output rows do not divide, a split input is
    gathered over ``space`` and the conv runs replicated; a 2x2 SAME
    max-pool follows the same rule (:func:`conv_rows`), its halo -inf past
    the image's bottom edge;
  * a residual add (:func:`add`) cuts a side holding whole rows or
    channels locally to the other side's slice, and a channel concat
    (:func:`cat_channels`) a side holding whole rows;
  * train-mode BatchNorm sums its moments over data x space while the
    layer's rows are split and over data once they are gathered
    (:meth:`ShardContext.batch_group`), never over ``model``: a rank holds
    every pixel of its channels;
  * a conv quantized with a dynamic per-tensor range (the int8-activation
    serving modes) takes the range of the whole tensor its input is a part
    of (:func:`tensor_range`), over the same group as BatchNorm: JAX's
    GSPMD program reduces it over the whole global batch.

The weights stay whole on every rank: TP shards the compute, not the
storage.  Each collective is an ``autograd.Function`` whose backward is its
adjoint (the gather's sums the incoming gradient over the group and keeps
this rank's slice; the halo's sends each halo row's gradient back to the
rank that owns the row).  So, with each rank's loss scaled by 1 / (mp *
sp) (it is replicated over its model and space peers), the sum over the
world of each parameter's gradient, divided by dp, is the gradient of the
global batch's loss (``training/train.py``).

The collectives are ``all_gather`` in its list form and ``all_reduce``
only: a sum for BatchNorm's moments and the gradients, a max for
:func:`tensor_range`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from k210_yolo_framework_tpu_torch.parallel import mesh as PM

__all__ = ["ShardContext", "Sharded", "add", "all_reduce_sum",
           "cat_channels", "conv_rows", "gather", "halo", "tensor_range"]


def _all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (one shape on all), in group-rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts


class _Gather(torch.autograd.Function):
    """Each rank's slice concatenated along ``dim`` in group-rank order;
    the backward sums the incoming gradient over the group (every rank's
    whole tensor fed that rank's loss) and keeps this rank's slice."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return torch.cat(_all_gather(x, group), dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(n, ctx.dim)[r], None, None


def gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """All-gather of this rank's slice of ``dim`` over ``group`` (channels:
    dim 1 over ``model``; rows: dim 2 over ``space``), differentiable."""
    return _Gather.apply(t, group, dim)


class _Halo(torch.autograd.Function):
    """This rank's rows [N, C, h, W] with ``above`` rows of the previous
    space rank on top and ``below`` rows of the next one underneath; rows
    of ``fill`` past the first and the last rank."""

    @staticmethod
    def forward(ctx, x, group, above, below, fill):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        h = x.shape[2]
        ctx.group, ctx.above, ctx.below, ctx.h = group, above, below, h
        # what the neighbours need of this rank: its first `below` rows
        # (the previous rank's bottom halo), its last `above` (the next's
        # top)
        parts = _all_gather(torch.cat([x[:, :, :below], x[:, :, h - above:]],
                                      2), group)
        n_, c, _, w = x.shape
        top = parts[r - 1][:, :, below:] if r > 0 else \
            x.new_full((n_, c, above, w), fill)
        bottom = parts[r + 1][:, :, :below] if r < n - 1 else \
            x.new_full((n_, c, below, w), fill)
        return torch.cat([top, x, bottom], 2)

    @staticmethod
    def backward(ctx, g):
        group, above, below, h = ctx.group, ctx.above, ctx.below, ctx.h
        n, r = dist.get_world_size(group), dist.get_rank(group)
        parts = _all_gather(torch.cat([g[:, :, :above], g[:, :, above + h:]],
                                      2), group)
        dx = g[:, :, above:above + h].clone()
        if r > 0:          # the previous rank's bottom halo: my first rows
            dx[:, :, :below] += parts[r - 1][:, :, above:]
        if r < n - 1:      # the next rank's top halo: my last rows
            dx[:, :, h - above:] += parts[r + 1][:, :, :above]
        return dx, None, None, None, None


def halo(t: torch.Tensor, group, above: int, below: int,
         fill: float = 0.0) -> torch.Tensor:
    """This rank's rows of an NCHW tensor split over ``group`` (the space
    axis) with ``above`` rows of the rank before and ``below`` of the rank
    after, ``fill`` past the image's edges (zeros: a conv's padding; -inf:
    a max-pool's); differentiable."""
    if above == 0 and below == 0:
        return t
    return _Halo.apply(t, group, above, below, fill)


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


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``, differentiable (BatchNorm's moments)."""
    return _AllReduceSum.apply(t, group)


def tensor_range(t: torch.Tensor, group, affine: bool = True):
    """The range of the whole tensor that ``t`` is this rank's part of:
    ``(min, max)`` where ``affine``, else the largest magnitude ``amax``
    (0-d fp32 tensors).  One ``all_reduce`` with ``MAX`` over ``group``
    (None: ``t`` is the whole tensor) of ``[-min, max]`` or ``[amax]``:
    a max is idempotent, so ranks holding the same rows or channels leave
    it as it is, and it equals ``amin`` / ``amax`` of the whole tensor bit
    for bit (negation is exact).  Serving only: no gradient."""
    if affine:
        r = torch.stack([-torch.amin(t), torch.amax(t)])
    else:
        r = torch.amax(t.abs()).reshape(1)
    if group is not None:
        dist.all_reduce(r, op=dist.ReduceOp.MAX, group=group)
    return (-r[0], r[1]) if affine else r[0]


class ShardContext:
    """What a TP/SP forward needs of a ``parallel.make_mesh`` mesh: the
    axes' sizes, this rank's model and space groups, and the groups
    BatchNorm sums over.  Made by every rank of the mesh at one point of
    the program (the pixel group is a new process group)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.dp, self.mp, self.sp = (PM.axis_size(mesh, a) for a in
                                     (PM.DATA_AXIS, PM.MODEL_AXIS,
                                      PM.SPACE_AXIS))
        self.model_group = PM.model_group(mesh) if self.mp > 1 else None
        self.space_group = PM.space_group(mesh) if self.sp > 1 else None
        self.data_group = PM.data_group(mesh) if self.dp > 1 else None
        self.pixel_group = PM.pixel_group(mesh) if self.sp > 1 \
            else self.data_group

    def batch_group(self, rows: bool):
        """The group over which a layer's batch statistics are spread: data
        x space while its rows are split, data after (None: this rank
        alone)."""
        return self.pixel_group if rows else self.data_group

    def channel_range(self, cout: int) -> Tuple[int, int]:
        return PM.channel_range(cout, self.mesh)

    def row_range(self, h: int) -> Tuple[int, int]:
        return PM.row_range(h, self.mesh)


class Sharded:
    """An NCHW activation of a TP/SP forward: this rank's part ``t``; with
    ``rows`` its rows are this rank's ``row_range`` of the whole, with
    ``channels`` its channels this rank's ``channel_range`` of the layer
    that made it."""

    __slots__ = ("t", "ctx", "rows", "channels")

    def __init__(self, t: torch.Tensor, ctx: ShardContext,
                 rows: bool = False, channels: bool = False):
        self.t, self.ctx, self.rows, self.channels = t, ctx, rows, channels

    def like(self, t: torch.Tensor) -> "Sharded":
        """``t`` (of this part's layout) as a Sharded."""
        return Sharded(t, self.ctx, self.rows, self.channels)

    def whole_channels(self, t: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """``t`` (default this part) with every channel: gathered over
        ``model`` where it holds a slice."""
        t = self.t if t is None else t
        return gather(t, self.ctx.model_group, 1) if self.channels else t

    def channel_slice(self, t: torch.Tensor, lo: int, hi: int
                      ) -> torch.Tensor:
        """``t`` (this part's layout, another dtype perhaps) as channels
        [lo, hi) of a layer whose own range that is: as it is where it holds
        that slice, cut locally where it holds every channel."""
        return t if self.channels else t[:, lo:hi]

    def full(self) -> torch.Tensor:
        """The whole tensor, on every rank: rows and channels gathered."""
        t = self.whole_channels()
        return gather(t, self.ctx.space_group, 2) if self.rows else t


def conv_rows(x: Sharded, t: torch.Tensor, kernel: int, stride: int,
              pads: Tuple[int, int], fill: float = 0.0
              ) -> Tuple[torch.Tensor, Tuple[int, int], bool]:
    """The input rows this rank's part of a conv (or of a pooling window)
    reads, from ``t`` (``x``'s rows, in the conv's dtype and channels):
    (rows, the (top, bottom) padding still to apply, whether the output's
    rows are split).  ``fill`` is the padding's value (0 for a conv, -inf
    for a max-pool), which the halo gives past the image's edges.

    The output is split where each space rank's output rows come from its
    own input rows plus a halo: output H * stride == input H, output H
    divides by sp, and the window reaches ``pads[0]`` rows above and
    ``kernel - stride - pads[0]`` below a rank's rows (a 3x3 stride-1 SAME
    conv one and one, a 3x3 stride-2 conv padded by 1 on an even H one
    above only, a 1x1 none; a 2x2 SAME pool none at stride 2, one below at
    stride 1).  Otherwise a split input is gathered and the conv runs
    replicated with its own padding (a stride-2 pool whose output rows do
    not divide by sp: a window would straddle two ranks)."""
    ctx = x.ctx
    top, bottom = pads
    h = t.shape[2] * (ctx.sp if x.rows else 1)
    out_h = (h + top + bottom - kernel) // stride + 1
    below = kernel - stride - top
    split = (ctx.sp > 1 and out_h * stride == h and out_h % ctx.sp == 0
             and below >= 0 and h // ctx.sp >= max(top, below))
    if not split:
        if x.rows:
            t = gather(t, ctx.space_group, 2)
        return t, pads, False
    if x.rows:
        return halo(t, ctx.space_group, top, below, fill), (0, 0), True
    lo, hi = ctx.row_range(h)
    part = t[:, :, max(lo - top, 0):min(hi + below, h)]
    return part, (max(top - lo, 0), max(hi + below - h, 0)), True


def cat_channels(parts: Sequence[Sharded]) -> Sharded:
    """Activations of one H concatenated on channels: each with every
    channel (a concat of slices is no slice of the concat), and, where one
    holds split rows, the replicated ones cut to this rank's rows."""
    rows = any(p.rows for p in parts)
    ts = []
    for p in parts:
        t = p.whole_channels()
        if rows and not p.rows:
            lo, hi = p.ctx.row_range(t.shape[2])
            t = t[:, :, lo:hi]
        ts.append(t)
    return Sharded(torch.cat(ts, 1), parts[0].ctx, rows, False)



def add(fresh: Sharded, other: Sharded) -> Sharded:
    """The sum of two activations of one whole shape (a residual add).
    Where both hold the same rows and channels their parts add; where one
    holds whole rows or whole channels and the other this rank's slice,
    the whole one is cut locally to the slice (no collective), so the sum
    holds the slice.  The backward is the identity on each side, the cut's
    scattering back into its whole tensor.  Without gradients the sum is
    written into ``fresh``'s tensor (or its cut view), which the caller
    owns; ``other``'s is only read (it may be a tap a later layer
    reads)."""
    ctx = fresh.ctx
    rows = fresh.rows or other.rows
    channels = fresh.channels or other.channels

    def cut(p: Sharded) -> torch.Tensor:
        t = p.t
        if channels and not p.channels:
            t = t[:, slice(*ctx.channel_range(t.shape[1]))]
        if rows and not p.rows:
            t = t[:, :, slice(*ctx.row_range(t.shape[2]))]
        return t

    a, b = cut(fresh), cut(other)
    if a.shape != b.shape:
        raise ValueError(f"add: parts of shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    t = a + b if torch.is_grad_enabled() else a.add_(b)
    return Sharded(t, ctx, rows, channels)

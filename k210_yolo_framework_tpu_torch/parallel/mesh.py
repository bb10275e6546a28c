"""Device mesh construction and sharding rules.

Counterpart of ``k210_yolo_framework_tpu/parallel/mesh.py``.  The mesh is
a ``torch.distributed.device_mesh.DeviceMesh`` of shape (dp, mp, sp) with
the dimension names ``data``, ``model`` and ``space``, over the process
group the caller has initialised (one process per device): NCCL on GPUs,
gloo on the CPU.  The sharding rules return DTensor placements, one per
mesh dimension:

  * batch arrays shard their leading dimension over ``data``;
  * NHWC images also shard H over ``space`` where sp > 1;
  * a conv kernel shards its output channels over ``model`` where their
    count divides by mp and is at least ``min_channels`` (dim 0 of the
    port's OIHW kernels, the last dim of JAX's HWIO ones);
  * everything else is replicated.

Serving over a mesh is ``inference.Predictor.make_sharded_runner``;
training on one is ``training.train.fit(mesh=)`` and its steps.  Both are
JAX's one GSPMD
program written out per rank: rank r of the data axis holds the batch
slots ``[r * B / dp, (r + 1) * B / dp)`` (:func:`slot_range`), and what
GSPMD reduces over the whole batch is summed over the data axis here
(:func:`sum_over_data`; gloo has no average, so a mean is a sum divided by
dp).  :func:`init_world` joins a process group the way the entry points
do: from torchrun's environment, or from an explicit ``file://`` URL;
:func:`spawn_ranks` starts a world's processes and waits for them.

The model and space axes (``parallel/sharded.py``): rank m of ``model``
computes output channels :func:`channel_range` of each kernel
:func:`param_shardings` marks, rank s of ``space`` rows :func:`row_range`
of each activation whose rows divide; BatchNorm's moments are summed over
:func:`pixel_group` (data x space) while a layer's rows are split, over
the data group after they are gathered; state and gradients over
:func:`world_group`.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Placement, Replicate, Shard

__all__ = ["DATA_AXIS", "MODEL_AXIS", "SPACE_AXIS", "axis_size",
           "batch_sharding", "channel_range", "data_group", "data_rank",
           "host_group", "image_sharding", "init_world", "make_mesh",
           "mean_over_data", "model_group", "model_rank", "param_shardings",
           "pixel_group", "replicated", "row_range", "shards_channels",
           "slot_range", "space_group", "space_rank", "spawn_ranks",
           "sum_over_data", "world_group"]

DATA_AXIS = "data"
MODEL_AXIS = "model"
SPACE_AXIS = "space"
_AXES = (DATA_AXIS, MODEL_AXIS, SPACE_AXIS)

Placements = Tuple[Placement, Placement, Placement]


def make_mesh(dp: Optional[int] = None, mp: int = 1, sp: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """Mesh of shape (dp, mp, sp) over the initialised process group's
    ranks; dp defaults to world_size // (mp * sp).  ``device_type``
    ``"cuda"`` (NCCL) or ``"cpu"`` (gloo)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialise the process group first "
                           "(torch.distributed.init_process_group)")
    n = dist.get_world_size()
    if dp is None:
        dp = n // (mp * sp)
    if dp * mp * sp != n:
        raise ValueError(f"dp*mp*sp = {dp}*{mp}*{sp} != {n} devices")
    return init_device_mesh(device_type, (dp, mp, sp), mesh_dim_names=_AXES)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The size of the named mesh dimension (1 where the mesh has none)."""
    names = mesh.mesh_dim_names or ()
    return mesh.shape[names.index(axis)] if axis in names else 1


def batch_sharding(mesh: DeviceMesh) -> Placements:
    """Leading-dim (batch) sharding over the data axis."""
    return tuple(Shard(0) if a == DATA_AXIS else Replicate() for a in _AXES)


def image_sharding(mesh: DeviceMesh) -> Placements:
    """NHWC image sharding: batch over ``data``, H over ``space``; with
    sp == 1 exactly ``batch_sharding``."""
    if axis_size(mesh, SPACE_AXIS) == 1:
        return batch_sharding(mesh)
    return (Shard(0), Replicate(), Shard(1))


def replicated(mesh: DeviceMesh) -> Placements:
    return (Replicate(),) * len(_AXES)


def param_shardings(state: Mapping[str, torch.Tensor], mesh: DeviceMesh,
                    min_channels: int = 128) -> Dict[str, Placements]:
    """Placements for each tensor of a state dict: a conv kernel [O, I, kh,
    kw] whose O divides by the model axis's size (> 1) and is at least
    ``min_channels`` shards O over ``model``; everything else is
    replicated.  With mp == 1 this is pure data parallelism."""
    mp = axis_size(mesh, MODEL_AXIS)

    def rule(t: torch.Tensor) -> Placements:
        if t.ndim == 4 and shards_channels(t.shape[0], mp, min_channels):
            return (Replicate(), Shard(0), Replicate())
        return replicated(mesh)

    return {name: rule(t) for name, t in state.items()}


def shards_channels(cout: int, mp: int, min_channels: int = 128) -> bool:
    """Whether a conv kernel of ``cout`` output channels shards them over a
    model axis of size ``mp``: mp > 1, cout divides by it and is at least
    ``min_channels`` (JAX's ``param_shardings`` rule)."""
    return mp > 1 and cout % mp == 0 and cout >= min_channels


def channel_range(cout: int, mesh: DeviceMesh) -> Tuple[int, int]:
    """The output channels ``[lo, hi)`` of a conv kernel of ``cout`` that
    this rank computes: ``[m * O / mp, (m + 1) * O / mp)`` for model rank m
    where :func:`shards_channels` marks the kernel, else all of them."""
    mp = axis_size(mesh, MODEL_AXIS)
    if not shards_channels(cout, mp):
        return 0, cout
    m = model_rank(mesh)
    return m * cout // mp, (m + 1) * cout // mp


def row_range(h: int, mesh: DeviceMesh) -> Tuple[int, int]:
    """The rows ``[lo, hi)`` of an activation of ``h`` rows that this rank
    holds: ``[s * H / sp, (s + 1) * H / sp)`` for space rank s where H
    divides by sp, else all of them (the layer runs replicated over
    ``space``)."""
    sp = axis_size(mesh, SPACE_AXIS)
    if sp == 1 or h % sp:
        return 0, h
    s = space_rank(mesh)
    return s * h // sp, (s + 1) * h // sp


def data_group(mesh: DeviceMesh) -> dist.ProcessGroup:
    """The process group of this rank's data axis."""
    return mesh.get_group(DATA_AXIS)


def data_rank(mesh: DeviceMesh) -> int:
    """This rank's index along the data axis."""
    return mesh.get_local_rank(DATA_AXIS)


def model_group(mesh: DeviceMesh) -> dist.ProcessGroup:
    """The process group of this rank's model axis."""
    return mesh.get_group(MODEL_AXIS)


def model_rank(mesh: DeviceMesh) -> int:
    """This rank's index along the model axis."""
    return mesh.get_local_rank(MODEL_AXIS)


def space_group(mesh: DeviceMesh) -> dist.ProcessGroup:
    """The process group of this rank's space axis."""
    return mesh.get_group(SPACE_AXIS)


def space_rank(mesh: DeviceMesh) -> int:
    """This rank's index along the space axis."""
    return mesh.get_local_rank(SPACE_AXIS)


def pixel_group(mesh: DeviceMesh) -> dist.ProcessGroup:
    """The group over which one batch's pixels are spread: this rank's
    data and space axes together (dp * sp ranks of one model coordinate).
    Made once a mesh: every rank calls ``new_group`` for every model
    coordinate, in the same order, the first time."""
    if not hasattr(mesh, "_pixel_groups"):
        grid = mesh.mesh.reshape(axis_size(mesh, DATA_AXIS),
                                 axis_size(mesh, MODEL_AXIS),
                                 axis_size(mesh, SPACE_AXIS))
        planes = [grid[:, m, :].flatten().tolist()
                  for m in range(grid.shape[1])]
        mesh._pixel_groups = [(ranks, dist.new_group(ranks))
                              for ranks in planes]
    me = dist.get_rank()
    return next(g for ranks, g in mesh._pixel_groups if me in ranks)


def world_group(mesh: DeviceMesh) -> dist.ProcessGroup:
    """The group of every rank of the mesh: the default group, which
    :func:`make_mesh` spans."""
    return dist.group.WORLD


def slot_range(batch: int, mesh: DeviceMesh) -> Tuple[int, int]:
    """The slots ``[lo, hi)`` of a global batch of ``batch`` that this rank
    holds: ``[r * B / dp, (r + 1) * B / dp)`` for data rank r."""
    dp = axis_size(mesh, DATA_AXIS)
    if batch % dp:
        raise ValueError(f"batch {batch} does not divide by the data axis's "
                         f"size {dp}")
    r = data_rank(mesh)
    return r * batch // dp, (r + 1) * batch // dp


def sum_over_data(t: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """``t`` summed over the ranks of ``group``, in place; returns ``t``."""
    dist.all_reduce(t, group=group)
    return t


def mean_over_data(t: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """``t`` averaged over the ranks of ``group``, in place: the sum
    divided by their count (gloo has no ``ReduceOp.AVG``)."""
    return sum_over_data(t, group).div_(dist.get_world_size(group))


def host_group(mesh: DeviceMesh) -> Tuple[dist.ProcessGroup, bool]:
    """A gloo group over every rank of the mesh, for host tensors: the
    world group itself where it is gloo, else a new one.  Returns (group,
    made); the caller destroys a group it was given new (``made``)."""
    group = world_group(mesh)
    if dist.get_backend(group) == "gloo":
        return group, False
    return dist.new_group(dist.get_process_group_ranks(group),
                          backend="gloo"), True


def init_world(device, init_method: Optional[str] = None, rank: int = 0,
               world_size: int = 1,
               backend: Optional[str] = None) -> torch.device:
    """Join the process group and return this rank's device.  Under
    torchrun (``RANK`` and ``WORLD_SIZE`` set) the group comes from its
    environment (``MASTER_ADDR`` / ``MASTER_PORT``, ``env://``) and the
    device index from ``LOCAL_RANK``; otherwise from ``init_method`` (a
    ``file://`` URL every rank is given) with ``rank`` and ``world_size``,
    the device index being the rank.  A CUDA ``device`` joins over NCCL
    (and raises where there is none: nothing falls back to gloo or to the
    CPU), ``"cpu"`` over gloo.  ``backend="gloo"`` with a CUDA ``device``
    asks for gloo over CUDA tensors instead: more ranks than cards, rank r
    on card ``r % device_count`` (NCCL refuses two ranks on one card)."""
    device = torch.device(device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        init_method = "env://"
    elif init_method is None:
        raise ValueError("init_world: outside torchrun, pass init_method (a "
                         "file:// URL), rank and world_size")
    else:
        local = rank
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"init_world: backend {backend!r} is neither nccl "
                         "nor gloo")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_world: no CUDA device is available")
        backend = backend or "nccl"
        if backend == "nccl" and not dist.is_nccl_available():
            raise RuntimeError("init_world: this torch has no NCCL; a CUDA "
                               "mesh does not fall back to gloo")
        if backend == "gloo":
            local %= torch.cuda.device_count()
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)     # the context before the group
    elif device.type == "cpu":
        if backend == "nccl":
            raise ValueError("init_world: NCCL needs a CUDA device")
        backend = "gloo"
    else:
        raise ValueError(f"init_world: device {str(device)!r} is neither "
                         "cuda nor cpu")
    # NCCL bound to this rank's card (barriers then need no guess)
    bound = dict(device_id=device) if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **bound)
    return device


def spawn_ranks(target: Callable, world: int, args: tuple = (),
                timeout: Optional[float] = None,
                meanwhile: Optional[Callable[[], None]] = None) -> None:
    """Run ``target(rank, *args)`` in ``world`` spawned processes and wait
    for all of them; each joins its world itself (:func:`init_world`).
    ``meanwhile()``, where given, runs here while the ranks do.  Raises,
    and ends the ranks still running, if a rank fails, ``meanwhile``
    raises or the ranks have not finished in ``timeout`` seconds."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(target, args=args, nprocs=world, join=False,
                             start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        if meanwhile is not None:
            meanwhile()
        while not ctx.join(timeout=1.0):      # raises if a rank failed
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"the world of {world} ranks did not "
                                   f"finish in {timeout} s")
    except BaseException:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
        raise

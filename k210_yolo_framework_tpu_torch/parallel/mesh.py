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

Serving over a pure data-parallel mesh is
``inference.Predictor.make_sharded_runner``; training on one is
``training.train.fit(mesh=)`` and its steps.  Both are JAX's one GSPMD
program written out per rank: rank r of the data axis holds the batch
slots ``[r * B / dp, (r + 1) * B / dp)`` (:func:`slot_range`), and what
GSPMD reduces over the whole batch is summed over the data axis here
(:func:`sum_over_data`; gloo has no average, so a mean is a sum divided by
dp).  :func:`init_world` joins a process group the way the entry points
do: from torchrun's environment, or from an explicit ``file://`` URL.
The model and space axes are not ported yet (ROADMAP queue 1 item 3):
:func:`require_data_parallel` refuses them.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Placement, Replicate, Shard

__all__ = ["DATA_AXIS", "MODEL_AXIS", "SPACE_AXIS", "axis_size",
           "batch_sharding", "data_group", "data_rank", "host_group",
           "image_sharding", "init_world", "make_mesh", "mean_over_data",
           "param_shardings", "replicated", "require_data_parallel",
           "slot_range", "sum_over_data"]

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
        if mp > 1 and t.ndim == 4 and t.shape[0] % mp == 0 \
                and t.shape[0] >= min_channels:
            return (Replicate(), Shard(0), Replicate())
        return replicated(mesh)

    return {name: rule(t) for name, t in state.items()}


def require_data_parallel(mesh: DeviceMesh, what: str) -> None:
    """Raise ``NotImplementedError`` unless the mesh is pure data
    parallelism (mp = sp = 1)."""
    if axis_size(mesh, MODEL_AXIS) != 1 or axis_size(mesh, SPACE_AXIS) != 1:
        raise NotImplementedError(
            f"{what} needs a pure data-parallel mesh (mp = sp = 1); the "
            "model and space axes are not ported yet (ROADMAP queue 1 "
            "item 3)")


def data_group(mesh: DeviceMesh) -> dist.ProcessGroup:
    """The process group of this rank's data axis."""
    return mesh.get_group(DATA_AXIS)


def data_rank(mesh: DeviceMesh) -> int:
    """This rank's index along the data axis."""
    return mesh.get_local_rank(DATA_AXIS)


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
    """A gloo group over this rank's data axis, for host tensors: the data
    group itself where it is gloo, else a new one.  Returns (group, made);
    the caller destroys a group it was given new (``made``)."""
    group = data_group(mesh)
    if dist.get_backend(group) == "gloo":
        return group, False
    return dist.new_group(dist.get_process_group_ranks(group),
                          backend="gloo"), True


def init_world(device, init_method: Optional[str] = None, rank: int = 0,
               world_size: int = 1) -> torch.device:
    """Join the process group and return this rank's device.  Under
    torchrun (``RANK`` and ``WORLD_SIZE`` set) the group comes from its
    environment (``MASTER_ADDR`` / ``MASTER_PORT``, ``env://``) and the
    device index from ``LOCAL_RANK``; otherwise from ``init_method`` (a
    ``file://`` URL every rank is given) with ``rank`` and ``world_size``,
    the device index being the rank.  A CUDA ``device`` joins over NCCL
    (and raises where there is none: nothing falls back to gloo or to the
    CPU), ``"cpu"`` over gloo."""
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
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_world: no CUDA device is available")
        if not dist.is_nccl_available():
            raise RuntimeError("init_world: this torch has no NCCL; a CUDA "
                               "mesh does not fall back to gloo")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_world: device {str(device)!r} is neither "
                         "cuda nor cpu")
    # NCCL bound to this rank's card (barriers then need no guess)
    bound = dict(device_id=device) if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **bound)
    return device

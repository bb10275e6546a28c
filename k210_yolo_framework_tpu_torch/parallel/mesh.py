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
``inference.Predictor.make_sharded_runner``.  Training on the mesh, and
the model and space axes, are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Placement, Replicate, Shard

__all__ = ["DATA_AXIS", "MODEL_AXIS", "SPACE_AXIS", "axis_size",
           "batch_sharding", "image_sharding", "make_mesh",
           "param_shardings", "replicated"]

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

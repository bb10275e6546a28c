"""The port's two entry contracts, the counterpart of the repository's
root ``__graft_entry__.py`` (which serves the JAX package):

``entry(device="cuda")``  a forward step on the flagship model
                          (yolo_mobilev1 alpha 0.75, the reference demo
                          config, seeded weights) and its inputs.
``dryrun_multichip(n, device="cuda")``
                          an n-process (data x model x space) mesh: ONE
                          fused train step with pruning on at tiny shapes,
                          then sharded serving on the same mesh held to one
                          process's detections.  On the card: NCCL, a card
                          a rank, where the machine has n cards, else n
                          gloo processes sharing the cards (the root's
                          virtual mesh when real chips are short);
                          ``device="cpu"``: n gloo processes on the CPU.
                          The line it prints names which.
"""

from __future__ import annotations

import tempfile
from pathlib import Path
from typing import Callable, Tuple

import numpy as np
import torch

__all__ = ["dryrun_multichip", "entry", "mesh_dims"]


def entry(device="cuda") -> Tuple[Callable, tuple]:
    """``(forward, (net, images))``: ``forward(net, images)`` returns the
    tuple of head outputs ([8, h, w, 3, 25] per layer) of ``net`` (eval
    mode, fp32) on ``images``, zeros of [8, 224, 320, 3] fp32.  A CUDA
    ``device`` with no card raises."""
    from k210_yolo_framework_tpu_torch.config import voc_spec
    from k210_yolo_framework_tpu_torch.models import build_network
    from k210_yolo_framework_tpu_torch.training.train import checked_device

    device = checked_device(device)
    spec = voc_spec()
    net = build_network("yolo_mobilev1", spec.in_hw, spec.nanchors,
                        spec.class_num, alpha=0.75,
                        generator=torch.Generator().manual_seed(0))
    net = net.to(device).eval().requires_grad_(False)

    def forward(net, images):
        return tuple(net(images))

    images = torch.zeros((8, *spec.in_hw, 3), dtype=torch.float32,
                         device=device)
    return forward, (net, images)


def mesh_dims(n: int) -> Tuple[int, int, int]:
    """(dp, mp, sp) for n devices, the root's rule: all three axes where
    the count allows (8 -> (2, 2, 2); 4 -> (2, 2, 1)), else pure DP."""
    sp = 2 if n % 4 == 0 and n >= 8 else 1
    mp = 2 if n % 2 == 0 and n >= 2 else 1
    return n // (mp * sp), mp, sp


def _dryrun(n: int, device: torch.device) -> str:
    """One rank's dryrun on the initialised world; returns the OK line."""
    import torch.distributed as dist

    from k210_yolo_framework_tpu_torch.config import TrainConfig, YoloSpec
    from k210_yolo_framework_tpu_torch.data import pipeline as PL
    from k210_yolo_framework_tpu_torch.inference import Predictor
    from k210_yolo_framework_tpu_torch.models import build_network
    from k210_yolo_framework_tpu_torch.parallel import (
        make_mesh,
        param_shardings,
    )
    from k210_yolo_framework_tpu_torch.training import train as TT
    from k210_yolo_framework_tpu_torch.utils.detmatch import (
        assert_detections_close,
    )

    # tiny shapes: 64x64 input -> 2x2 / 4x4 grids (strides 32 / 16)
    spec = YoloSpec.create((64, 64), ((2, 2), (4, 4)), 4,
                           np.array([[[0.7, 0.6], [0.5, 0.5], [0.4, 0.3]],
                                     [[0.3, 0.3], [0.2, 0.2], [0.1, 0.1]]]))
    dp, mp, sp = mesh_dims(n)
    mesh = make_mesh(dp, mp, sp, device_type=device.type)
    cfg = TrainConfig(batch_size=n, is_prune=True, prune_end_epoch=1,
                      prune_frequency=1)
    net = build_network("yolo_mobilev1", spec.in_hw, spec.nanchors,
                        spec.class_num, alpha=0.75,
                        generator=torch.Generator().manual_seed(0))
    state = TT.shard_state(TT.create_train_state(net, cfg, device), mesh)
    # the fused step fit() runs: preprocess (letterbox, augment, /max,
    # encode) of each rank's slots, then the sharded forward / backward /
    # update; the model axis slices the wide kernels' channels, the space
    # axis the rows
    step = TT.make_fused_train_step(
        spec, cfg, PL.make_preprocess_fn(spec, is_training=True),
        train_epoch_step=2, mesh=mesh)

    rng = np.random.default_rng(0)
    boxes = np.concatenate([
        rng.integers(0, 4, (n, 2, 1)).astype(np.float32),
        rng.uniform(0.2, 0.8, (n, 2, 2)),
        rng.uniform(0.2, 0.5, (n, 2, 2))], -1).astype(np.float32)
    canvases = rng.integers(0, 256, (n, 96, 96, 3)).astype(np.uint8)
    img_hws = np.tile(np.asarray([72, 96], np.int32), (n, 1))
    valid = np.ones((n, 2), bool)
    state, logs = step(state, canvases, img_hws, boxes, valid,
                       torch.Generator().manual_seed(1))
    loss = float(logs["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"dryrun loss not finite: {loss}")
    if mp > 1 and not any(
            pl[1].is_shard() for pl in param_shardings(
                dict(state.net.named_parameters()), mesh).values()):
        raise AssertionError("expected kernels sliced over the model axis")

    # serving on the same mesh: the sharded runner against this process's
    # own program, as detection sets (a collective's fp32 order may flip a
    # score-tied greedy decision)
    pred = Predictor(state.net, None, spec, obj_thresh=0.05,
                     iou_thresh=0.45, max_out=10, device=device)
    local = pred._run_batch(torch.from_numpy(canvases).to(device),
                            torch.from_numpy(img_hws).to(device))
    served = pred.make_sharded_runner(mesh)(canvases, img_hws)
    assert_detections_close(type(local)(*(t.cpu().numpy() for t in local)),
                            type(served)(*(t.cpu().numpy()
                                           for t in served)))
    n_det = int(served.valid.sum())
    if device.type == "cpu":
        on = f"{n} gloo processes on the CPU"
    elif dist.get_backend() == "nccl":
        on = f"{n} NCCL ranks on {torch.cuda.get_device_name(device)}"
    else:
        on = (f"{n} gloo processes sharing {torch.cuda.device_count()} "
              f"{torch.cuda.get_device_name(device)}")
    return (f"dryrun_multichip({n}) OK: mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}, loss "
            f"{loss:.3f}; sharded serving matches single-device "
            f"({n_det} detections); {on}")


def _rank(rank: int, n: int, device_type: str, backend: str,
          init_method: str, out_dir: str) -> None:
    """One spawned rank: join the world, run the dryrun, rank 0 writes the
    OK line."""
    import torch.distributed as dist

    from k210_yolo_framework_tpu_torch.parallel import init_world

    if device_type == "cpu":
        torch.set_num_threads(1)     # n processes share the host's cores
    device = init_world(device_type, init_method, rank, n, backend)
    try:
        line = _dryrun(n, device)
        if rank == 0:
            Path(out_dir, "line").write_text(line)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Spawn the world of ``n_devices`` ranks, run the dryrun on every rank
    and print rank 0's OK line; a failing rank raises here.  On the card
    (the default; none present raises) the world is NCCL, a card a rank,
    where the machine has ``n_devices`` cards, else gloo over CUDA tensors
    with the ranks sharing the cards (the root's virtual mesh when real
    chips are short); ``device="cpu"`` makes it gloo processes on the
    CPU."""
    from k210_yolo_framework_tpu_torch.parallel import spawn_ranks
    from k210_yolo_framework_tpu_torch.training.train import checked_device

    device = checked_device(device)
    backend = ("nccl" if device.type == "cuda"
               and n_devices <= torch.cuda.device_count() else "gloo")
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        spawn_ranks(_rank, n_devices, (n_devices, device.type, backend,
                                       f"file://{tmp}/init", tmp))
        print(Path(tmp, "line").read_text(), flush=True)

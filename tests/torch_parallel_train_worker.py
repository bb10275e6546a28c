"""One rank of a gloo world for ``tests/test_torch_parallel_train.py``, and
the same runs in one process for its references.

Started by ``torch_parallel_worker.spawn_world(..., target=run)``; imports
torch, numpy and the port only, never JAX.  The job (a pickle written by
the test) holds the small net's weights as a native flat dict, a batch of
images and labels, a host batch of canvases with its augment draws, a
BatchNorm input, and the rank that raises the stop flag; each rank joins
through ``parallel.init_world`` (``file://``), runs every case on the
mesh and writes what it saw to ``<out_dir>/rank<r>.pkl``.
"""

from __future__ import annotations

import itertools
import os
import pickle
import signal
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from k210_yolo_framework_tpu_torch import config as TConfig
from k210_yolo_framework_tpu_torch.data import pipeline as PL
from k210_yolo_framework_tpu_torch.models import build_network
from k210_yolo_framework_tpu_torch.models.layers import BatchNorm, Int8Act
from k210_yolo_framework_tpu_torch.ops.augment import AugmentParams
from k210_yolo_framework_tpu_torch.parallel import (
    data_group,
    init_world,
    make_mesh,
    slot_range,
    sum_over_data,
)
from k210_yolo_framework_tpu_torch.parallel.sharded import ShardContext
from k210_yolo_framework_tpu_torch.training import checkpoint as TC
from k210_yolo_framework_tpu_torch.training import train as TT


def _cfg(job, **kw) -> TConfig.TrainConfig:
    return TConfig.TrainConfig(batch_size=len(job["images"]),
                               init_learning_rate=job["lr"], **kw)


def _prune_cfg(job) -> TConfig.TrainConfig:
    """``test_parallel_equivalence.py``'s pruning overlay."""
    return _cfg(job, is_prune=True, prune_initial_sparsity=0.2,
                prune_final_sparsity=0.6, prune_end_epoch=1,
                prune_frequency=1)


def _spec(job) -> TConfig.YoloSpec:
    return TConfig.YoloSpec.create(*job["spec_args"])


def _net(job, spec):
    net = build_network(job["model"], spec.in_hw, spec.nanchors,
                        spec.class_num, alpha=job["alpha"])
    net.load_state_dict(TC.state_dict_from_flat(job["flat"], net))
    return net


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().contiguous().numpy().copy()


def snapshot(state) -> dict:
    """Everything a replicated state holds, as numpy: the net's state dict,
    each parameter's Adam moments and step, the masks, the counters and
    the step count."""
    snap = {f"net/{k}": _np(v) for k, v in state.net.state_dict().items()}
    for name, p in state.net.named_parameters():
        for k, v in state.optimizer.state.get(p, {}).items():
            snap[f"adam/{name}/{k}"] = _np(v)
    snap.update({f"mask/{k}": _np(v) for k, v in state.masks.items()})
    snap.update({f"pr/{k}": _np(v) for k, v in state.pr.items()})
    snap["step"] = state.step
    return snap


def _scalars(logs) -> dict:
    return {k: float(v) for k, v in logs.items()}


def train_plain(job, mesh=None, order=None, prune=False) -> dict:
    """``job['steps']`` steps of ``make_train_step`` on the job's batch
    (its rows in ``order``); on a mesh, this rank's slots of it.  Returns
    the first step's gradients (native keys), each step's logs and the
    final state."""
    cfg = _prune_cfg(job) if prune else _cfg(job)
    spec = _spec(job)
    state = TT.create_train_state(_net(job, spec), cfg, "cpu")
    images, labels = job["images"], job["labels"]
    if order is not None:
        images, labels = images[order], [lab[order] for lab in labels]
    if mesh is not None:
        lo, hi = slot_range(len(images), mesh)
        images, labels = images[lo:hi], [lab[lo:hi] for lab in labels]
        TT.shard_state(state, mesh)
    step = TT.make_train_step(spec, cfg, train_epoch_step=job["steps"],
                              mesh=mesh)
    images = torch.from_numpy(np.ascontiguousarray(images))
    labels = [torch.from_numpy(np.ascontiguousarray(lab)) for lab in labels]
    logs, grads = [], None
    for _ in range(job["steps"]):
        state, lg = step(state, images, labels)
        logs.append(_scalars(lg))
        if grads is None:
            grads = TC.flat_from_state_dict(
                {n: p.grad for n, p in state.net.named_parameters()})
    return dict(grads=grads, logs=logs, final=snapshot(state))


def _draws(job, i) -> AugmentParams:
    return AugmentParams(*(torch.from_numpy(a) for a in job["draws"][i]))


def train_fused(job, mesh=None) -> dict:
    """The fused step with augment on over the job's host batch, one set
    of injected draws a step; on a mesh each rank is given the whole host
    batch.  Returns each step's preprocessed slots (images, labels), logs
    and the final state."""
    cfg = _cfg(job, augment=True)
    spec = _spec(job)
    state = TT.create_train_state(_net(job, spec), cfg, "cpu")
    pp = PL.make_preprocess_fn(spec, True)
    host = PL.HostBatch(*job["host"])
    shard = {}
    if mesh is None:
        host = host.to("cpu")
    else:
        TT.shard_state(state, mesh)
        shard = dict(slots=slot_range(len(host.img_hws), mesh), device="cpu")
    fused = TT.make_fused_train_step(spec, cfg, pp, mesh=mesh)
    slots, logs = [], []
    for i in range(len(job["draws"])):
        with torch.no_grad():
            images, labels = pp(*host, params=_draws(job, i), **shard)
        slots.append((_np(images), [_np(lab) for lab in labels]))
        state, lg = fused(state, *host, params=_draws(job, i))
        logs.append(_scalars(lg))
    return dict(slots=slots, logs=logs, final=snapshot(state))


def bn_moments(job, mesh=None) -> dict:
    """One train-mode BatchNorm on the job's input (this rank's slots on a
    mesh, with the data group set) and the backward of sum(y * g); on a
    mesh the weight and bias gradients are summed over the ranks (the
    global loss is the sum of the ranks')."""
    x, g = torch.from_numpy(job["bn_x"]), torch.from_numpy(job["bn_g"])
    bn = BatchNorm(x.shape[1]).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(job["bn_scale"]))
        bn.bias.copy_(torch.from_numpy(job["bn_bias"]))
    if mesh is not None:
        lo, hi = slot_range(len(x), mesh)
        x, g = x[lo:hi], g[lo:hi]
        bn.data_group = data_group(mesh)
    x = x.clone().requires_grad_()
    y = bn(x)
    (y * g).sum().backward()
    if mesh is not None:
        for p in (bn.weight, bn.bias):
            sum_over_data(p.grad, bn.data_group)
    return dict(y=_np(y), mean=_np(bn.running_mean), var=_np(bn.running_var),
                x_grad=_np(x.grad), w_grad=_np(bn.weight.grad),
                b_grad=_np(bn.bias.grad))


def stop_on_one_rank(job, mesh, rank: int) -> dict:
    """``fit`` on the mesh for up to 1000 steps; the rank
    ``job['stop_rank']`` sends itself SIGTERM during step 2."""
    spec = _spec(job)
    pp = PL.make_preprocess_fn(spec, False)
    calls = {"n": 0}

    def preprocess(*args, **kw):
        calls["n"] += 1
        if rank == job["stop_rank"] and calls["n"] == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return pp(*args, **kw)

    lines = []
    state = TT.fit(_net(job, spec), spec, _cfg(job, max_epochs=1),
                   itertools.repeat(PL.HostBatch(*job["host"])), None,
                   preprocess, pp, 1000, 0, device="cpu", mesh=mesh,
                   log_fn=lines.append)
    return dict(step=state.step, lines=lines)


def _raised(fn, kind) -> str:
    try:
        fn()
    except kind as e:
        return str(e)
    return ""


def run(rank: int, world: int, init_file: str, job_file: str,
        out_dir: str) -> None:
    torch.set_num_threads(1)
    init_world("cpu", f"file://{init_file}", rank, world)
    try:
        job = pickle.loads(Path(job_file).read_bytes())
        mesh = make_mesh(device_type="cpu")
        seen = {"slots": slot_range(len(job["images"]), mesh)}
        seen["plain"] = train_plain(job, mesh)
        if job.get("full"):
            seen["fused"] = train_fused(job, mesh)
            seen["prune"] = train_plain(job, mesh, prune=True)
            seen["bn"] = bn_moments(job, mesh)
            seen["stop"] = stop_on_one_rank(job, mesh, rank)
            seen["odd_error"] = _raised(
                lambda: slot_range(len(job["images"]) - 1, mesh), ValueError)
            if world % 2 == 0:
                spec = _spec(job)
                tp = make_mesh(dp=world // 2, mp=2, device_type="cpu")
                sp = make_mesh(dp=world // 2, sp=2, device_type="cpu")
                # what the model axis refuses to train: a forward under
                # Int8Act (a serving mode); recalibrate_batch_stats on the
                # space axis runs
                seen["model_error"] = _raised(
                    lambda: _net(job, spec)(torch.zeros(1, *spec.in_hw, 3),
                                            dtype=Int8Act(torch.float32),
                                            shard=ShardContext(tp)),
                    NotImplementedError)
                net = _net(job, spec)
                seen["space_error"] = _raised(
                    lambda: TT.recalibrate_batch_stats(
                        net, iter([PL.HostBatch(*job["host"])]),
                        PL.make_preprocess_fn(spec, False), num_batches=1,
                        device="cpu", mesh=sp), NotImplementedError)
                seen["space_stats"] = {
                    name: (_np(m.running_mean), _np(m.running_var))
                    for name, m in net.named_modules()
                    if isinstance(m, BatchNorm)}
        Path(out_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(seen))
    finally:
        dist.destroy_process_group()

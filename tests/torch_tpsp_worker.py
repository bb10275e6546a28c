"""One rank of a four-rank gloo world for ``tests/test_torch_tpsp_serving.py``
and ``tests/test_torch_tpsp_train.py``: the model and space axes.

Started by ``torch_parallel_worker.spawn_world(..., target=serve or
train)``; imports torch, numpy and the port only, never JAX.  Each rank
joins through ``parallel.init_world`` (``file://``) and runs every case of
its job on the meshes ``job['meshes']`` (dp, mp, sp), one after another on
the same world, then writes what it saw to ``<out_dir>/rank<r>.pkl``.
"""

from __future__ import annotations

import itertools
import pickle
from pathlib import Path

import torch
import torch.distributed as dist

from k210_yolo_framework_tpu_torch import config as TConfig
from k210_yolo_framework_tpu_torch.data import pipeline as PL
from k210_yolo_framework_tpu_torch.inference import Predictor
from k210_yolo_framework_tpu_torch.models import build_network
from k210_yolo_framework_tpu_torch.models.layers import BatchNorm
from k210_yolo_framework_tpu_torch.parallel import (
    channel_range,
    init_world,
    make_mesh,
    param_shardings,
    row_range,
    slot_range,
)
from k210_yolo_framework_tpu_torch.parallel.sharded import (
    ShardContext,
    Sharded,
    gather,
    halo,
)
from k210_yolo_framework_tpu_torch.training import train as TT

import torch_parallel_train_worker as TW
import torch_parallel_worker as SW


def _raised(fn, kind) -> str:
    try:
        fn()
    except kind as e:
        return str(e)
    return ""


def _mesh_name(dims) -> str:
    dp, mp, sp = dims
    return "".join(f"{a}{n}" for a, n in (("dp", dp), ("tp", mp), ("sp", sp))
                   if n > 1)


def _join(rank, world, init_file, job_file):
    torch.set_num_threads(1)
    init_world("cpu", f"file://{init_file}", rank, world)
    return pickle.loads(Path(job_file).read_bytes())


# ---- serving -----------------------------------------------------------

def serve(rank: int, world: int, init_file: str, job_file: str,
          out_dir: str) -> None:
    """The job's Predictor through ``make_sharded_runner`` on each mesh;
    what a model or space axis still refuses; the kernels each rank's
    model coordinate computes a slice of."""
    job = _join(rank, world, init_file, job_file)
    try:
        seen = {"results": {}, "ranges": {}}
        spec = TConfig.YoloSpec.create(*job["spec_args"])
        for dims in job["meshes"]:
            mesh = make_mesh(*dims, device_type="cpu")
            pred = SW._predictor(job)
            runner = pred.make_sharded_runner(mesh)
            seen["results"][_mesh_name(dims)] = [
                t.numpy() for t in runner(job["canvases"], job["hws"])]
            marked = sorted(
                name for name, pl in param_shardings(
                    dict(pred.net.state_dict()), mesh).items()
                if any(p.is_shard() for p in pl))
            seen["ranges"][_mesh_name(dims)] = {
                name: channel_range(
                    pred.net.get_parameter(name).shape[0], mesh)
                for name in marked}
        tp = make_mesh(1, 2, 2, device_type="cpu")
        quantized = Predictor(
            build_network(job["model"], spec.in_hw, spec.nanchors,
                          spec.class_num, alpha=job["alpha"]),
            None, spec, quantize="int8", device="cpu")
        seen["quantize_error"] = _raised(
            lambda: quantized.make_sharded_runner(tp), NotImplementedError)
        tiny = Predictor(build_network("tiny_yolo", spec.in_hw,
                                       spec.nanchors, spec.class_num),
                         None, spec, device="cpu")
        seen["builder_error"] = _raised(
            lambda: tiny.make_sharded_runner(tp), NotImplementedError)
        Path(out_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(seen))
    finally:
        dist.destroy_process_group()


# ---- training ------------------------------------------------------------

def _halo_and_gather(job, mesh, device="cpu") -> dict:
    """The collectives alone on (1, 2, 2): this rank's rows with their halo,
    its channels gathered, and the gradient of sum(out * g) through each
    (g the same whole tensor on every rank), for the test to hold against
    zero-padded whole rows and the single-process gradient."""
    ctx = ShardContext(mesh)
    x = torch.from_numpy(job["coll_x"]).to(device)
    g = torch.from_numpy(job["coll_g"]).to(device)
    rlo, rhi = row_range(x.shape[2], mesh)
    m, c = dist.get_rank(ctx.model_group), x.shape[1]
    clo, chi = m * c // ctx.mp, (m + 1) * c // ctx.mp
    above, below = 1, 1
    part = x[:, :, rlo:rhi].clone().requires_grad_()
    out = halo(part, ctx.space_group, above, below)
    # the halo'd rows are rows [rlo - 1, rhi + 1) of the zero-padded whole
    (out * torch.nn.functional.pad(g, (0, 0, 1, 1))[
        :, :, rlo:rhi + above + below]).sum().backward()
    cpart = x[:, clo:chi].clone().requires_grad_()
    gathered = gather(cpart, ctx.model_group, 1)
    (gathered * g).sum().backward()
    return dict(rows=(rlo, rhi), channels=(clo, chi),
                halo=TW._np(out), halo_grad=TW._np(part.grad),
                gathered=TW._np(gathered), gather_grad=TW._np(cpart.grad))


def _bn_rule(job, mesh) -> dict:
    """One train-mode BatchNorm on (dp, 1, sp) = (2, 1, 2): this rank's
    slots and rows of the job's input, rows split (moments over data x
    space) and whole (moments over data), and sum(y * g)'s gradients, the
    weight's and bias's summed over the world."""
    ctx = ShardContext(mesh)
    x, g = torch.from_numpy(job["bn_x"]), torch.from_numpy(job["bn_g"])
    lo, hi = slot_range(len(x), mesh)
    rlo, rhi = row_range(x.shape[2], mesh)
    out = {}
    for name, rows in (("split", True), ("whole", False)):
        bn = BatchNorm(x.shape[1]).train()
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(job["bn_scale"]))
            bn.bias.copy_(torch.from_numpy(job["bn_bias"]))
        part = x[lo:hi, :, rlo:rhi] if rows else x[lo:hi]
        gpart = g[lo:hi, :, rlo:rhi] if rows else g[lo:hi]
        part = part.clone().requires_grad_()
        y = bn(part, Sharded(part, ctx, rows=rows))
        (y * gpart).sum().backward()
        for p in (bn.weight, bn.bias):
            # the world's sum over the replicas: each (data, space) part's
            # share once, each replica of the whole rows 1 / sp
            dist.all_reduce(p.grad)
            if not rows:
                p.grad /= ctx.sp
        out[name] = dict(y=TW._np(y), x_grad=TW._np(part.grad),
                         mean=TW._np(bn.running_mean),
                         var=TW._np(bn.running_var),
                         w_grad=TW._np(bn.weight.grad),
                         b_grad=TW._np(bn.bias.grad),
                         rows=(rlo, rhi) if rows else (0, x.shape[2]),
                         slots=(lo, hi))
    return out


def _fit_state(job, mesh) -> dict:
    """``fit`` with pruning and augment on, 3 steps of the host batch and a
    validation step on it, and each rank's snapshot of the state after it
    and the lines it logged."""
    spec = TW._spec(job)
    cfg = TW._cfg(job, max_epochs=1, augment=True, is_prune=True,
                  prune_initial_sparsity=0.2, prune_final_sparsity=0.6,
                  prune_end_epoch=1, prune_frequency=1)
    lines = []
    host = PL.HostBatch(*job["host"])
    state = TT.fit(TW._net(job, spec), spec, cfg, itertools.repeat(host),
                   itertools.repeat(host), PL.make_preprocess_fn(spec, True),
                   PL.make_preprocess_fn(spec, False), 3, 1, device="cpu",
                   generator=torch.Generator().manual_seed(3), mesh=mesh,
                   log_fn=lines.append)
    return dict(final=TW.snapshot(state), lines=lines)


def _ranges(mesh) -> dict:
    """row_range and channel_range where rows or channels divide and where
    they do not."""
    return dict(rows={h: row_range(h, mesh) for h in (8, 7, 2, 1)},
                channels={c: channel_range(c, mesh)
                          for c in (256, 128, 129, 96)})


def train(rank: int, world: int, init_file: str, job_file: str,
          out_dir: str) -> None:
    """``make_train_step`` on each mesh; the collectives alone; the
    BatchNorm group rule; the ranges; ``fit``'s state and a stop raised on
    a model or space rank; what the axes still refuse."""
    job = _join(rank, world, init_file, job_file)
    try:
        seen = {"plain": {}}
        for dims in job["meshes"]:
            mesh = make_mesh(*dims, device_type="cpu")
            seen["plain"][_mesh_name(dims)] = TW.train_plain(job, mesh)
        tpsp = make_mesh(1, 2, 2, device_type="cpu")
        seen["collectives"] = _halo_and_gather(job, tpsp)
        seen["ranges"] = _ranges(tpsp)
        dpsp = make_mesh(2, 1, 2, device_type="cpu")
        seen["bn"] = _bn_rule(job, dpsp)
        seen["fit"] = _fit_state(job, tpsp)
        seen["stop"] = TW.stop_on_one_rank(job, tpsp, rank)
        spec = TW._spec(job)
        tiny = build_network("tiny_yolo", spec.in_hw, spec.nanchors,
                             spec.class_num)
        seen["builder_error"] = _raised(
            lambda: tiny(torch.zeros(1, *spec.in_hw, 3),
                         shard=ShardContext(tpsp)), NotImplementedError)
        seen["recalibrate_error"] = _raised(
            lambda: TT.recalibrate_batch_stats(
                TW._net(job, spec), iter(()), None, device="cpu",
                mesh=dpsp), NotImplementedError)
        Path(out_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(seen))
    finally:
        dist.destroy_process_group()


# ---- on the card (tests/test_torch_cuda.py) ------------------------------

def cuda_collectives(rank: int, world: int, init_file: str, job_file: str,
                     out_dir: str) -> None:
    """The halo and the channel gather on CUDA tensors over a gloo world
    of processes sharing card 0 (NCCL refuses two ranks on one card): the
    forward and the backward of sum(out * g), as ``_halo_and_gather``."""
    torch.cuda.set_device(0)
    torch.zeros(1, device="cuda")
    job = pickle.loads(Path(job_file).read_bytes())
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        dev = torch.device("cuda", 0)
        mesh = make_mesh(1, world // 2, 2, device_type="cuda")
        seen = _halo_and_gather(job, mesh, dev)
        Path(out_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(seen))
    finally:
        dist.destroy_process_group()

"""One rank of a gloo world for ``tests/test_torch_parallel.py``.

Started by :func:`spawn_world` (``parallel.spawn_ranks``); imports torch, numpy
and the port only, never JAX: the children start no JAX.  The job (a
pickle written by the test) names the weights, the batch, a rank whose
stem kernel is put off by one before its runner is made, and what to
check; each rank writes what it saw to ``<out_dir>/rank<r>.pkl``.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

from k210_yolo_framework_tpu_torch import config as TConfig
from k210_yolo_framework_tpu_torch.inference import Predictor
from k210_yolo_framework_tpu_torch.models import build_network
from k210_yolo_framework_tpu_torch.parallel import (
    batch_sharding,
    image_sharding,
    init_world,
    make_mesh,
    param_shardings,
    replicated,
    spawn_ranks,
)
from k210_yolo_framework_tpu_torch.training import checkpoint as TC


def _raised(fn, kind) -> str:
    try:
        fn()
    except kind as e:
        return str(e)
    return ""


def _predictor(job):
    spec = TConfig.YoloSpec.create(*job["spec_args"])
    net = build_network(job["model"], spec.in_hw, spec.nanchors,
                        spec.class_num, alpha=job["alpha"])
    return Predictor(net, TC.state_dict_from_flat(job["flat"], net), spec,
                     compute_dtype=torch.float32, device="cpu",
                     **job["predictor"])


def run(rank: int, world: int, init_file: str, job_file: str,
        out_dir: str) -> None:
    torch.set_num_threads(1)
    init_world("cpu", f"file://{init_file}", rank, world)
    try:
        job = pickle.loads(Path(job_file).read_bytes())
        seen = {}
        mesh = make_mesh(device_type="cpu")
        seen["shape"] = tuple(mesh.shape)
        seen["names"] = tuple(mesh.mesh_dim_names)
        seen["size_error"] = _raised(
            lambda: make_mesh(dp=world + 1, device_type="cpu"), ValueError)
        seen["placements"] = {
            "batch": batch_sharding(mesh), "image": image_sharding(mesh),
            "replicated": replicated(mesh)}
        pred = _predictor(job)
        stem = pred.net.stem.conv.weight
        if rank == job.get("perturbed_rank"):
            # the runner must replace these by rank 0's weights
            with torch.no_grad():
                stem.add_(1.0)
        seen["stem_before"] = stem.detach().clone().numpy()
        runner = pred.make_sharded_runner(mesh)
        seen["stem_after"] = stem.detach().clone().numpy()
        seen["result"] = [t.numpy() for t in runner(job["canvases"],
                                                    job["hws"])]
        odd = len(job["hws"]) - 1
        seen["odd_error"] = _raised(
            lambda: runner(job["canvases"][:odd], job["hws"][:odd]),
            ValueError)
        if job.get("model_axis") and world % 2 == 0:
            space = make_mesh(dp=world // 2, sp=2, device_type="cpu")
            seen["space_image"] = image_sharding(space)
            tp = make_mesh(dp=world // 2, mp=2, device_type="cpu")
            state = dict(pred.net.state_dict())
            seen["model_marked"] = sorted(
                name for name, pl in param_shardings(state, tp).items()
                if any(isinstance(p, Shard) for p in pl))
            # a quantize mode the model axis used to refuse: int8 on tp2,
            # against the same Predictor's single-process program
            quantized = Predictor(
                build_network(job["model"], pred.spec.in_hw,
                              pred.spec.nanchors, pred.spec.class_num,
                              alpha=job["alpha"]),
                None, pred.spec, quantize="int8", device="cpu",
                **job["predictor"])
            got = quantized.make_sharded_runner(tp)(job["canvases"],
                                                    job["hws"])
            want = quantized._run_batch(torch.from_numpy(job["canvases"]),
                                        torch.from_numpy(job["hws"]))
            seen["model_int8"] = ([t.numpy() for t in got],
                                  [t.numpy() for t in want])
        Path(out_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(seen))
    finally:
        dist.destroy_process_group()


def spawn_world(world: int, job: dict, tmp: Path,
                timeout: float = 300.0, target=run, meanwhile=None) -> list:
    """Run ``target`` (default ``run``; any function of the same arguments
    that writes ``<out_dir>/rank<r>.pkl``) on ``world`` gloo ranks
    (``parallel.spawn_ranks``); returns each rank's record.
    ``meanwhile()``, where given, runs here while the ranks do.  Raises
    (and ends the ranks) if ``meanwhile`` raises or the ranks have not
    finished in ``timeout`` seconds."""
    job_file = tmp / "job.pkl"
    job_file.write_bytes(pickle.dumps(job))
    spawn_ranks(target, world, (world, str(tmp / "init"), str(job_file),
                                str(tmp)), timeout, meanwhile)
    return [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
            for r in range(world)]


def port_local(job) -> list:
    """The port's single-process ``_run_batch`` of the job's batch."""
    res = _predictor(job)._run_batch(torch.from_numpy(job["canvases"]),
                          torch.from_numpy(job["hws"]))
    return [t.numpy() for t in res]

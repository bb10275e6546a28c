"""One rank of a four-rank gloo world for ``tests/test_torch_tpsp_serving.py``,
``tests/test_torch_tpsp_train.py``, ``tests/test_torch_tpsp_quantize.py``
and the builders' files ``tests/test_torch_tpsp_{mobilev2,tiny,yolo}.py``:
the model and space axes.

Started by ``torch_parallel_worker.spawn_world(..., target=serve, train,
quantized or builder)``; imports torch, numpy and the port only, never
JAX.  Each rank joins through ``parallel.init_world`` (``file://``) and
runs every
case of its job on the meshes ``job['meshes']`` (dp, mp, sp), one after
another on the same world, then writes what it saw to
``<out_dir>/rank<r>.pkl``.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import pickle
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from k210_yolo_framework_tpu_torch import config as TConfig
from k210_yolo_framework_tpu_torch.data import pipeline as PL
from k210_yolo_framework_tpu_torch.inference import Predictor
from k210_yolo_framework_tpu_torch.models import build_network
from k210_yolo_framework_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    Int8Act,
    max_pool_same,
    smooth_max_pool_same,
    smooth_witness,
)
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
    add,
    gather,
    halo,
)
from k210_yolo_framework_tpu_torch.training import checkpoint as TC
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
    the int8 and patches Predictors on tp2*sp2 and the int8-activation
    train-mode refusal there; the kernels each rank's model coordinate
    computes a slice of."""
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
        # what the axes used to refuse: int8 and the patches stem serve on
        # tp2*sp2, against the same Predictor's own program; a train-mode
        # forward under Int8Act refuses, as in JAX
        tp = make_mesh(1, 2, 2, device_type="cpu")
        seen["served_on_tpsp"] = {}
        for quantize, stem_mode in (("int8", "default"), (None, "patches")):
            pred = quantized_predictor(job, quantize, stem_mode)
            got = pred.make_sharded_runner(tp)(job["canvases"], job["hws"])
            want = pred._run_batch(torch.from_numpy(job["canvases"]),
                                   torch.from_numpy(job["hws"]))
            seen["served_on_tpsp"][quantize or stem_mode] = (
                [t.numpy() for t in got], [t.numpy() for t in want])
        net = build_network(job["model"], spec.in_hw, spec.nanchors,
                            spec.class_num, alpha=job["alpha"]).train()
        seen["train_int8_error"] = _raised(
            lambda: net(torch.zeros(1, *spec.in_hw, 3),
                        dtype=Int8Act(torch.float32),
                        shard=ShardContext(tp)), NotImplementedError)
        Path(out_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(seen))
    finally:
        dist.destroy_process_group()


# ---- quantized serving and the patches stem ------------------------------

# the int8 conv kinds held bit for bit, (cin, kernel, strides, pads): 1x1,
# 3x3 SAME (zp read past every edge) and the 3x3 stride-2 stem of three
# input channels padded by 1, int8 as in the nativeconv stem mode
INT8_CONVS = {"1x1": (128, (1, 1), (1, 1), ((0, 0), (0, 0))),
              "3x3": (128, (3, 3), (1, 1), ((1, 1), (1, 1))),
              "stem": (3, (3, 3), (2, 2), ((1, 1), (1, 1)))}
INT8_ACTS = {"affine": Int8Act(torch.float32),
             "symmetric": Int8Act(torch.float32, affine=False),
             "static": Int8Act(torch.float32, static=True)}
# the served configurations: (quantize, stem_mode)
QUANTIZED = {"int8": ("int8", "default"),
             "int8_act": ("int8_act", "default"),
             "int8_act_sym": ("int8_act_sym", "default"),
             "int8_act_cal": ("int8_act_cal", "default"),
             "patches": (None, "patches"),
             "patches_int8": ("int8", "patches"),
             "nativeconv_int8_act": ("int8_act", "nativeconv")}


def int8_conv(job, kind: str) -> Conv:
    """The job's conv of ``kind`` (``INT8_CONVS``), int8-capable, its
    weights ``job['conv_w'][kind]`` and calibrated range
    ``job['conv_static'][kind]``."""
    cin, kernel, strides, pads = INT8_CONVS[kind]
    w = torch.from_numpy(job["conv_w"][kind])
    conv = Conv(cin, w.shape[0], kernel, strides, pads).requires_grad_(False)
    conv.weight.copy_(w)
    conv.int8_capable = conv.int8_rule("nativeconv")
    for buf, v in zip(conv.act_ranges("cpu"), job["conv_static"][kind]):
        buf.fill_(float(v))
    return conv


def _sharded_int8_convs(job, mesh) -> dict:
    """Each ``INT8_CONVS`` kind in each ``INT8_ACTS`` mode on this rank's
    part of ``job['conv_x'][kind]`` (its slots; the 128-channel inputs as
    their model rank's channel slice and space rank's rows, the stem's
    whole, as an image comes), gathered whole; and again with each range
    taken over the rank's own part alone (the group patched away)."""
    ctx = ShardContext(mesh)

    def whole(y: Sharded) -> np.ndarray:
        t = y.full()
        return TW._np(gather(t, ctx.data_group, 0) if ctx.data_group
                      else t)

    out = {}
    for kind in INT8_CONVS:
        x = torch.from_numpy(job["conv_x"][kind])[slice(*slot_range(
            len(job["conv_x"][kind]), mesh))]
        image = kind == "stem"
        rows, channels = not image and ctx.sp > 1, not image and ctx.mp > 1
        if channels:
            x = x[:, slice(*ctx.channel_range(x.shape[1]))]
        if rows:
            x = x[:, :, slice(*row_range(x.shape[2], mesh))]
        conv = int8_conv(job, kind)
        for mode, act in INT8_ACTS.items():
            with torch.no_grad():
                y = conv.forward_int8(Sharded(x, ctx, rows, channels), act)
                with mock.patch.object(ShardContext, "batch_group",
                                       lambda self, rows: None):
                    own = whole(conv.forward_int8(
                        Sharded(x, ctx, rows, channels), act))
            out[(kind, mode)] = dict(y=whole(y), own=own,
                                     layout=(y.rows, y.channels))
    return out


def quantized_predictor(job, quantize, stem_mode) -> Predictor:
    """``torch_parallel_worker._predictor`` in ``quantize`` and
    ``stem_mode``."""
    return SW._predictor(dict(job, predictor={
        **job["predictor"], "quantize": quantize, "stem_mode": stem_mode}))


def act_ranges_of(pred: Predictor) -> dict:
    """Each int8 conv's calibrated (act_min, act_max), by scope."""
    return {m.scope: (float(m.act_min), float(m.act_max))
            for m in pred.net.modules() if hasattr(m, "act_min")}


def recorded(fn) -> tuple:
    """``fn()``'s result; each ``Conv.int8_range`` it took (scope, xmin,
    xmax), in call order; and the ``all_reduce`` calls it made."""
    ranges, reduces = [], [0]
    int8_range, all_reduce = Conv.int8_range, dist.all_reduce

    def record(self, xf, act, group=None):
        r = int8_range(self, xf, act, group)
        ranges.append((self.scope, float(r[0]), float(r[1])))
        return r

    def count(*args, **kwargs):
        reduces[0] += 1
        return all_reduce(*args, **kwargs)

    with mock.patch.object(Conv, "int8_range", record), \
            mock.patch.object(dist, "all_reduce", count):
        out = fn()
    return out, ranges, reduces[0]


def quantized(rank: int, world: int, init_file: str, job_file: str,
              out_dir: str) -> None:
    """On each mesh of ``job['meshes']``: the int8 convs alone
    (``_sharded_int8_convs``), and each ``QUANTIZED`` configuration served
    through ``make_sharded_runner`` (its result, the ranges each int8 conv
    took and the all-reduces of one call; in ``int8_act_cal`` world rank 0
    calibrates on ``job['calib']``, ranks 1-2 on ``job['calib_other']``,
    rank 3 not at all, and each rank's ranges before and after the runner
    is made are kept).  Then ``int8_act`` on the pure data-parallel mesh
    of the four ranks: its result and ranges."""
    job = _join(rank, world, init_file, job_file)
    try:
        seen = {"convs": {}, "served": {}}
        for dims in job["meshes"]:
            mesh = make_mesh(*dims, device_type="cpu")
            name = _mesh_name(dims)
            seen["convs"][name] = _sharded_int8_convs(job, mesh)
            for cfg, (quantize, stem_mode) in QUANTIZED.items():
                pred = quantized_predictor(job, quantize, stem_mode)
                rec = {}
                if quantize == "int8_act_cal":
                    calib = job["calib"] if rank == 0 else job["calib_other"]
                    if rank < 3:
                        pred.calibrate(*calib)
                    rec["own_ranges"] = act_ranges_of(pred)
                runner = pred.make_sharded_runner(mesh)
                rec["served_ranges"] = act_ranges_of(pred)
                res, rec["ranges"], rec["all_reduces"] = recorded(
                    lambda: runner(job["canvases"], job["hws"]))
                rec["result"] = [t.numpy() for t in res]
                seen["served"][(name, cfg)] = rec
        dp = make_mesh(world, 1, 1, device_type="cpu")
        runner = quantized_predictor(job, "int8_act", "default") \
            .make_sharded_runner(dp)
        res, ranges, _ = recorded(lambda: runner(job["canvases"],
                                                 job["hws"]))
        seen["dp"] = dict(result=[t.numpy() for t in res], ranges=ranges)
        Path(out_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(seen))
    finally:
        dist.destroy_process_group()


# ---- training ------------------------------------------------------------

def stem_patches(images: torch.Tensor) -> torch.Tensor:
    """NHWC images [B, H, W, C] -> the 3x3 stride-2 stem's zero-padded
    patches [B, H / 2, 3, W / 2, 3, C] (``stem_mode='patches'``'s input)."""
    xp = torch.nn.functional.pad(images, (0, 0, 1, 1, 1, 1))
    return xp.unfold(1, 3, 2).unfold(2, 3, 2).permute(0, 1, 4, 2, 5, 3)


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
    a model or space rank; on tp2*sp2 the train-mode forward of the patches
    stem and the refusal of a train-mode one under Int8Act; and the
    recalibration on dp2*sp2."""
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
        patches = TW._net(job, spec)
        patches.stem_mode = "patches"
        with torch.no_grad():
            seen["patches_heads"] = [TW._np(h) for h in patches(
                stem_patches(torch.from_numpy(job["images"])),
                shard=ShardContext(tpsp))]
        seen["train_int8_error"] = _raised(
            lambda: TW._net(job, spec)(torch.zeros(1, *spec.in_hw, 3),
                                       dtype=Int8Act(torch.float32),
                                       shard=ShardContext(tpsp)),
            NotImplementedError)
        seen["recalibrated"] = _recalibrated(
            dict(job, recal_hosts=[job["host"]]), dpsp)
        Path(out_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(seen))
    finally:
        dist.destroy_process_group()


# ---- the other builders (tests/test_torch_tpsp_{mobilev2,tiny,yolo}.py) ----

def leaf_rel_l1(a: dict, b) -> dict:
    """Each leaf's sum|x - y| / sum|y| (``b`` a dict or a :func:`read_flat`
    mapping)."""
    assert sorted(a) == sorted(b)
    out = {}
    for k in sorted(b):
        x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        out[k] = float(np.abs(x - y).sum() / (np.abs(y).sum() + 1e-12))
    return out


def rel_l1(a: dict, b) -> float:
    """test_parallel_equivalence._rel_l1: the worst leaf's sum|x - y| /
    sum|y|."""
    return max(leaf_rel_l1(a, b).values())


def read_flat(stem: str, timeout: float = 600.0) -> dict:
    """``torch_tpsp_parity.write_flat``'s flat dict, memory-mapped; waits
    for the test process to write it (its index comes last)."""
    deadline = time.monotonic() + timeout
    while not Path(stem + ".json").exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"no reference {stem} in {timeout} s")
        time.sleep(0.2)
    index = json.loads(Path(stem + ".json").read_text())
    data = np.load(stem + ".npy", mmap_mode="r")
    return {k: data[o:o + int(np.prod(shape))].reshape(shape)
            for k, (o, shape) in index.items()}


def _digest(state) -> str:
    """One hash of everything a replicated state holds (the net's state
    dict, Adam's moments and steps, the counters, the step count)."""
    h = hashlib.sha1(str(state.step).encode())
    tensors = list(state.net.state_dict().values()) + list(state.pr.values())
    for p in state.net.parameters():
        tensors += [v for _, v in sorted(state.optimizer.state.get(
            p, {}).items())]
    for t in tensors:
        h.update(t.detach().to(torch.float32).contiguous().numpy().tobytes())
    return h.hexdigest()


def _held_steps(job, mesh, refs) -> dict:
    """This rank's slots of the job's batch through ``make_train_step``:
    ``job['steps']`` steps of the smooth witness
    (``layers.smooth_witness``: each kink and max-pool smoothed), each
    step's logs, the first step's gradients and the final parameters as
    each leaf's rel-L1 error against the references ``refs``
    (``read_flat`` stems), and each gradient leaf's largest entry;
    and one step of the net itself, its logs.  A digest of each final
    state."""
    cfg, spec = TW._cfg(job), TW._spec(job)
    lo, hi = slot_range(len(job["images"]), mesh)
    images = torch.from_numpy(np.ascontiguousarray(job["images"][lo:hi]))
    labels = [torch.from_numpy(np.ascontiguousarray(lab[lo:hi]))
              for lab in job["labels"]]
    step = TT.make_train_step(spec, cfg, train_epoch_step=job["steps"],
                              mesh=mesh)

    def state_of(net):
        return TT.shard_state(TT.create_train_state(net, cfg, "cpu"), mesh)

    state = state_of(smooth_witness(TW._net(job, spec)))
    logs = []
    for i in range(job["steps"]):
        state, lg = step(state, images, labels)
        logs.append(TW._scalars(lg))
        if i == 0:
            grads = TC.flat_from_state_dict(
                {n: p.grad for n, p in state.net.named_parameters()})
    params = TC.flat_from_state_dict(dict(state.net.named_parameters()))
    smooth = dict(logs=logs, digest=_digest(state),
                  grads_err=leaf_rel_l1(grads, read_flat(refs["grads"])),
                  grads_max={k: float(np.abs(g).max())
                             for k, g in grads.items()},
                  params_err=leaf_rel_l1(params, read_flat(refs["params"])),
                  gspmd_params_err=leaf_rel_l1(
                      params, read_flat(refs["gspmd_params"])))
    del grads, params
    state, lg = step(state_of(TW._net(job, spec)), images, labels)
    return dict(smooth=smooth, kinked=dict(logs=[TW._scalars(lg)],
                                           digest=_digest(state)))


def _whole_rows(x: torch.Tensor, mesh, split: bool) -> Sharded:
    """``x``'s rows as this rank holds them: its ``row_range`` where
    ``split``, else whole; every channel."""
    ctx = ShardContext(mesh)
    if split:
        x = x[:, :, slice(*row_range(x.shape[2], mesh))]
    return Sharded(x.clone().requires_grad_(), ctx, rows=split)


# (H, stride, the input's rows split): the -inf halo below at stride 1, no
# halo at stride 2, a stride-2 pool whose 3 output rows do not divide (a
# window would straddle the ranks: gathered), a replicated input cut
# locally, an odd H pooled whole
POOL_CASES = ((8, 1, True), (6, 1, True), (8, 2, True), (6, 2, True),
              (8, 1, False), (7, 2, False))
POOLS = {"max": max_pool_same, "smooth": smooth_max_pool_same}


def _pools(job, mesh, device="cpu") -> dict:
    """tp2sp2: ``max_pool_same`` and ``smooth_max_pool_same`` of this
    rank's part of each ``POOL_CASES`` input (negative everywhere, so a
    zero pad would win a window), and the gradient of sum(out * g) through
    each, a rank's loss scaled by 1 / sp where its output is replicated
    over space."""
    out = {}
    sp = ShardContext(mesh).sp
    for name, pool in POOLS.items():
        for h, stride, split in POOL_CASES:
            x = torch.from_numpy(job["pool_x"][:, :, :h]).to(device)
            g = torch.from_numpy(job["pool_g"][:, :, :-(-h // stride),
                                               :-(-x.shape[3] // stride)]
                                 ).to(device)
            part = _whole_rows(x, mesh, split)
            y = pool(part, stride)
            rows = slice(*row_range(g.shape[2], mesh)) if y.rows \
                else slice(None)
            ((y.t * g[:, :, rows]).sum() / (1 if y.rows else sp)).backward()
            out.setdefault(name, {})[(h, stride, split)] = dict(
                y=TW._np(y.t), y_rows=y.rows, x_grad=TW._np(part.t.grad),
                in_rows=row_range(h, mesh) if split else (0, h),
                out_rows=row_range(g.shape[2], mesh) if y.rows
                else (0, g.shape[2]))
    return out


def assert_pools_whole(ranks, job, case, pool) -> None:
    """``_pools``'s records of a (1, 2, 2) world (``ranks``, by world rank)
    against the whole tensor: each rank's output rows are the whole
    pool's, split where the output rows divide by sp (at stride 1 the last
    rank's bottom window takes the -inf pad, not a zero row; a stride-2
    pool of 3 output rows is gathered and pooled whole), and the input
    gradients of one model coordinate's two space ranks add up to the
    whole pool's."""
    h, stride, _ = case
    x = torch.from_numpy(job["pool_x"][:, :, :h]).requires_grad_()
    y = POOLS[pool](x, stride)
    g = torch.from_numpy(job["pool_g"][:, :, :y.shape[2], :y.shape[3]])
    (y * g).sum().backward()
    y, want_grad = y.detach().numpy(), x.grad.numpy()
    out_h = -(-h // stride)
    for m in range(2):
        grad = np.zeros_like(want_grad)
        for rank in (2 * m, 2 * m + 1):
            rec = ranks[rank]["pools"][pool][case]
            assert rec["y_rows"] == (out_h * stride == h and out_h % 2 == 0)
            lo, hi = rec["out_rows"]
            np.testing.assert_allclose(rec["y"], y[:, :, lo:hi], rtol=1e-6,
                                       atol=1e-6)
            lo, hi = rec["in_rows"]
            grad[:, :, lo:hi] += rec["x_grad"]
        np.testing.assert_allclose(grad, want_grad, rtol=1e-6, atol=1e-6)


def _adds(job, mesh) -> dict:
    """tp2sp2: ``sharded.add`` of two activations of 128 channels and 4
    rows in every pair of layouts (rows split or whole, channels this
    model rank's half or whole): the sum, each side's gradient of
    sum(out * g), and, without gradients, whether only ``fresh`` was
    written."""
    ctx = ShardContext(mesh)
    a, b, g = (torch.from_numpy(job[k]) for k in ("add_a", "add_b",
                                                  "add_g"))
    clo, chi = ctx.channel_range(a.shape[1])
    rlo, rhi = row_range(a.shape[2], mesh)

    def part(t, rows, channels):
        t = t[:, clo:chi] if channels else t
        return t[:, :, rlo:rhi] if rows else t

    out = {}
    layouts = list(itertools.product((False, True), repeat=2))
    for fresh_l, other_l in itertools.product(layouts, repeat=2):
        fa = part(a, *fresh_l).clone().requires_grad_()
        ob = part(b, *other_l).clone().requires_grad_()
        y = add(Sharded(fa, ctx, *fresh_l), Sharded(ob, ctx, *other_l))
        (y.t * part(g, y.rows, y.channels)).sum().backward()
        with torch.no_grad():
            fn, on = part(a, *fresh_l).clone(), part(b, *other_l).clone()
            kept = on.clone()
            yn = add(Sharded(fn, ctx, *fresh_l), Sharded(on, ctx, *other_l))
            into_fresh = yn.t.untyped_storage().data_ptr() == \
                fn.untyped_storage().data_ptr()
        out[(fresh_l, other_l)] = dict(
            y=TW._np(y.t), layout=(y.rows, y.channels),
            fresh_grad=TW._np(fa.grad), other_grad=TW._np(ob.grad),
            no_grad_equal=bool(torch.equal(yn.t, y.t.detach())),
            other_untouched=bool(torch.equal(on, kept)),
            into_fresh=bool(into_fresh))
    return dict(cases=out, rows=(rlo, rhi), channels=(clo, chi))


def _recalibrated(job, mesh) -> dict:
    """``recalibrate_batch_stats(mesh=)`` over the job's host batches:
    every BatchNorm's statistics after it, by module name."""
    spec = TW._spec(job)
    net = TW._net(job, spec)
    hosts = [PL.HostBatch(*h) for h in job["recal_hosts"]]
    TT.recalibrate_batch_stats(net, iter(hosts),
                               PL.make_preprocess_fn(spec, False),
                               num_batches=len(hosts), device="cpu",
                               mesh=mesh)
    return {name: (TW._np(m.running_mean), TW._np(m.running_var))
            for name, m in net.named_modules() if isinstance(m, BatchNorm)}


def builder(rank: int, world: int, init_file: str, job_file: str,
            out_dir: str) -> None:
    """The job's builder on each mesh: served through
    ``make_sharded_runner`` in fp32 and in each ``job['quantized']``
    configuration, then trained (``_held_steps``, against the
    reference files ``job['refs']``, which the test process writes while
    the ranks run); then, as the job asks, the sharded
    pools (``pools``), adds (``adds``) and recalibration (``recalibrate``:
    on dp2*sp2 and tp2*sp2)."""
    job = _join(rank, world, init_file, job_file)
    try:
        seen = {"results": {}, "train": {}}
        meshes = {_mesh_name(dims): make_mesh(*dims, device_type="cpu")
                  for dims in job["meshes"]}
        for name, mesh in meshes.items():
            runner = SW._predictor(job).make_sharded_runner(mesh)
            seen["results"][name] = [
                t.numpy() for t in runner(job["canvases"], job["hws"])]
            for cfg in job["quantized"]:
                runner = quantized_predictor(
                    job, *QUANTIZED[cfg]).make_sharded_runner(mesh)
                seen["results"][(name, cfg)] = [
                    t.numpy() for t in runner(job["canvases"], job["hws"])]
            del runner
        for name, mesh in meshes.items():
            seen["train"][name] = _held_steps(job, mesh, job["refs"])
        tpsp = make_mesh(1, 2, 2, device_type="cpu")
        if job.get("pools"):
            seen["pools"] = _pools(job, tpsp)
        if job.get("adds"):
            seen["adds"] = _adds(job, tpsp)
        if job.get("recalibrate"):
            seen["recalibrated"] = {
                _mesh_name(dims): _recalibrated(
                    job, make_mesh(*dims, device_type="cpu"))
                for dims in ((2, 1, 2), (1, 2, 2))}
        Path(out_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(seen))
    finally:
        dist.destroy_process_group()


# ---- on the card (tests/test_torch_cuda.py) ------------------------------

def cuda_collectives(rank: int, world: int, init_file: str, job_file: str,
                     out_dir: str) -> None:
    """The halo and the channel gather on CUDA tensors over a gloo world
    of processes sharing the card (``init_world(backend="gloo")``: NCCL
    refuses two ranks on one card): the
    forward and the backward of sum(out * g), as ``_halo_and_gather``."""
    dev = init_world("cuda", f"file://{init_file}", rank, world,
                     backend="gloo")
    job = pickle.loads(Path(job_file).read_bytes())
    try:
        mesh = make_mesh(1, world // 2, 2, device_type="cuda")
        seen = _halo_and_gather(job, mesh, dev)
        Path(out_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(seen))
    finally:
        dist.destroy_process_group()


def cuda_pools(rank: int, world: int, init_file: str, job_file: str,
               out_dir: str) -> None:
    """``_pools`` on CUDA tensors over a gloo world of four processes
    sharing the card, on (1, 2, 2)."""
    dev = init_world("cuda", f"file://{init_file}", rank, world,
                     backend="gloo")
    job = pickle.loads(Path(job_file).read_bytes())
    try:
        mesh = make_mesh(1, 2, 2, device_type="cuda")
        seen = {"pools": _pools(job, mesh, dev)}
        Path(out_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(seen))
    finally:
        dist.destroy_process_group()

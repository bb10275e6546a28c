"""The port's data-parallel training (``fit(mesh=)``, the sharded train
and fused steps, ``shard_state``, BatchNorm's global statistics) against
its own single-process step and against the JAX package's sharded step,
at ``tests/test_parallel_equivalence.py``'s shapes: yolo_mobilev1 alpha
0.25, 64x64 input, B=8, 3 steps.

The ranks are gloo worlds of CPU processes (``torch.multiprocessing``
spawn, ``file://`` init through ``parallel.init_world``), each in
``tests/torch_parallel_train_worker.py``, which imports no JAX.  The
statistic is the JAX test's: the sharded step reorders the batch
reductions (BatchNorm's moments, the loss, the gradients), which stacked
train-mode BatchNorms amplify, so gradients and parameters are held to 10x
a batch-permutation control (the same samples in another order, one
process), worst leaf by relative L1; the first step's loss to rtol 1e-5.
What can be exact is held exactly: each rank's preprocessed slots against
the single-process batch's, and the state every rank holds against every
other rank's (replicated: the same collective results on each).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from k210_yolo_framework_tpu import config as JConfig
from k210_yolo_framework_tpu.parallel import batch_sharding, image_sharding
from k210_yolo_framework_tpu.parallel import make_mesh as jax_make_mesh
from k210_yolo_framework_tpu.training import loss as JLoss
from k210_yolo_framework_tpu.training import metrics as JM
from k210_yolo_framework_tpu.training import pruning as JP
from k210_yolo_framework_tpu.training import train as JT
from k210_yolo_framework_tpu.training.checkpoint import _path_key
from k210_yolo_framework_tpu_torch import config as TConfig
from k210_yolo_framework_tpu_torch import parallel as TP
from k210_yolo_framework_tpu_torch.ops import augment as TA
from k210_yolo_framework_tpu_torch.ops import codec as TCodec
from k210_yolo_framework_tpu_torch.training import checkpoint as TC
from k210_yolo_framework_tpu_torch.training import train as TT

import torch_parallel_train_worker as W
from torch_parallel_worker import spawn_world
from torch_parity import jax_weights

torch.set_num_threads(1)

ANCHORS = np.array([[[0.7, 0.6], [0.5, 0.5], [0.4, 0.3]],
                    [[0.3, 0.3], [0.2, 0.2], [0.1, 0.1]]], np.float32)
SPEC_ARGS = ((64, 64), ((2, 2), (4, 4)), 4, ANCHORS)
JSPEC = JConfig.YoloSpec.create(*SPEC_ARGS)
TSPEC = TConfig.YoloSpec.create(*SPEC_ARGS)
BATCH, STEPS, LR = 8, 3, 1e-3
# the control: the same batch, halves swapped, in one process
SWAPPED = np.r_[BATCH // 2:BATCH, 0:BATCH // 2]


def _job(full=True):
    """The batch of test_parallel_equivalence._batch (2 boxes an image,
    images U(0, 1)), a host batch of 8 canvases with 3 steps of augment
    draws, a BatchNorm input and the stopping rank."""
    rng = np.random.default_rng(0)
    boxes = np.concatenate([
        rng.integers(0, 4, (BATCH, 2, 1)).astype(np.float32),
        rng.uniform(0.2, 0.8, (BATCH, 2, 2)),
        rng.uniform(0.2, 0.5, (BATCH, 2, 2))], -1).astype(np.float32)
    labels = [lab.numpy() for lab in TCodec.encode_labels_batch(
        torch.from_numpy(boxes), torch.ones(BATCH, 2, dtype=torch.bool),
        TSPEC)]
    images = rng.uniform(0, 1, (BATCH, 64, 64, 3)).astype(np.float32)

    hws = np.array([[80, 96], [64, 64], [40, 96], [80, 50]] * 2, np.int32)
    canvases = np.zeros((BATCH, 80, 96, 3), np.uint8)
    padded, valid = [], []
    for i, (h, w) in enumerate(hws):
        canvases[i, :h, :w] = rng.integers(0, 256, (h, w, 3))
        nb = int(rng.integers(1, 4))
        b, v = TCodec.pad_boxes(np.hstack([
            rng.integers(0, 4, (nb, 1)).astype(float),
            rng.uniform(0.2, 0.8, (nb, 2)), rng.uniform(0.1, 0.4, (nb, 2))]))
        padded.append(b)
        valid.append(v)
    gen = torch.Generator().manual_seed(5)
    draws = [tuple(t.numpy() for t in TA.draw_params(BATCH, (64, 64),
                                                     generator=gen))
             for _ in range(STEPS)]
    return dict(
        model="yolo_mobilev1", alpha=0.25, spec_args=SPEC_ARGS, lr=LR,
        steps=STEPS, full=full,
        flat=jax_weights("yolo_mobilev1", (64, 64), 3, 4, alpha=0.25)[2],
        images=images, labels=labels,
        host=(canvases, hws, np.stack(padded).astype(np.float32),
              np.stack(valid)),
        draws=draws,
        bn_x=(rng.standard_normal((BATCH, 6, 5, 7)) * 2 + 1).astype(
            np.float32),
        bn_g=rng.standard_normal((BATCH, 6, 5, 7)).astype(np.float32),
        bn_scale=rng.uniform(0.5, 1.5, 6).astype(np.float32),
        bn_bias=rng.standard_normal(6).astype(np.float32),
        stop_rank=1)


JOB = _job()


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return spawn_world(2, JOB, tmp_path_factory.mktemp("train2"),
                       target=W.run)


@functools.lru_cache(maxsize=None)
def _local(kind, order=None):
    """The single-process references, cached per test process."""
    order = None if order is None else np.asarray(order)
    if kind == "plain":
        return W.train_plain(JOB, order=order)
    if kind == "prune":
        return W.train_plain(JOB, order=order, prune=True)
    if kind == "fused":
        return W.train_fused(JOB)
    return W.bn_moments(JOB)


def _params(snap) -> dict:
    """The parameters of a snapshot, by the native keys."""
    return TC.flat_from_state_dict(
        {k[4:]: torch.from_numpy(v) for k, v in snap.items()
         if k.startswith("net/") and k.endswith(("weight", "bias"))})


def _rel_l1(a: dict, b: dict) -> float:
    """test_parallel_equivalence._rel_l1: the worst leaf's sum|x - y| /
    sum|y|."""
    assert sorted(a) == sorted(b)
    worst = 0.0
    for k in b:
        x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        worst = max(worst, np.abs(x - y).sum() / (np.abs(y).sum() + 1e-12))
    return worst


def _assert_within_control(got, ref, ctl):
    """got's first-step gradients and final parameters within 10x the
    control's distance from ref; the first step's loss to rtol 1e-5."""
    np.testing.assert_allclose(got["logs"][0]["loss"], ref["logs"][0]["loss"],
                               rtol=1e-5)
    for what, of in (("grads", lambda r: r["grads"]),
                     ("params", lambda r: _params(r["final"]))):
        if what == "grads" and "grads" not in ref:
            continue
        floor = max(_rel_l1(of(ctl), of(ref)), 1e-6)
        err = _rel_l1(of(got), of(ref))
        assert err < 10 * floor, (what, err, floor)


def _assert_replicated(seen, case):
    r0 = seen[0][case]["final"]
    for s in seen[1:]:
        got = s[case]["final"]
        assert sorted(got) == sorted(r0)
        for k in r0:
            np.testing.assert_array_equal(got[k], r0[k], err_msg=k)
        assert s[case]["logs"] == seen[0][case]["logs"]


def test_ranks_hold_contiguous_slots_and_refuse_an_odd_batch(world2):
    assert [s["slots"] for s in world2] == [(0, 4), (4, 8)]
    for s in world2:
        assert s["odd_error"] == ("batch 7 does not divide by the data "
                                  "axis's size 2")


def test_sharded_step_matches_the_single_process_step(world2):
    """(a) The first step's loss, the initial gradients of the global loss
    and the parameters after 3 steps; the counters of step 1 are the whole
    batch's."""
    ref, ctl = _local("plain"), _local("plain", tuple(SWAPPED))
    for s in world2:
        _assert_within_control(s["plain"], ref, ctl)
        got, want = s["plain"]["logs"][0], ref["logs"][0]
        for k in ("p", "r", "l1_p", "l1_r", "l2_p", "l2_r"):
            assert got[k] == pytest.approx(want[k], abs=1e-6), k


def test_the_state_stays_replicated_on_every_rank(world2):
    """Parameters, BN statistics, Adam moments and steps, masks, counters,
    step count and logged scalars: bit for bit the same on both ranks,
    plain, pruned and fused."""
    for case in ("plain", "prune", "fused"):
        _assert_replicated(world2, case)
    final = world2[0]["plain"]["final"]
    assert final["step"] == STEPS
    assert any(k.startswith("adam/") and k.endswith("exp_avg_sq")
               for k in final)


def _jax_flat(tree) -> dict:
    return {f"params/{_path_key(p)}": np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _jax_run(dp=None, swapped=False):
    """JAX's jitted make_train_step (and gradient) on the job's batch, on
    one device or on a (dp, 1, 1) mesh of the first dp CPU devices."""
    jnet, variables, _ = jax_weights("yolo_mobilev1", (64, 64), 3, 4,
                                     alpha=0.25)
    cfg = JConfig.TrainConfig(batch_size=BATCH, init_learning_rate=LR)
    params = jax.tree.map(jnp.copy, variables["params"])
    state = JT.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.copy, variables["batch_stats"]),
        opt_state=JT.make_optimizer(cfg).init(params),
        masks=JP.init_masks(params), pr=JM.init_pr_state(2))
    order = SWAPPED if swapped else np.arange(BATCH)
    images = jnp.asarray(JOB["images"][order])
    labels = tuple(jnp.asarray(lab[order]) for lab in JOB["labels"])
    if dp is not None:
        mesh = jax_make_mesh(dp=dp, devices=jax.devices()[:dp])
        state = JT.shard_state(state, mesh)
        images = jax.device_put(images, image_sharding(mesh))
        labels = tuple(jax.device_put(lab, batch_sharding(mesh))
                       for lab in labels)

    def loss_fn(p, bs, x, lab):
        outs, _ = jnet.apply({"params": p, "batch_stats": bs}, x, train=True)
        main = JLoss.yolo_loss(lab, outs, JSPEC, BATCH, cfg.obj_thresh,
                               cfg.iou_thresh, cfg.obj_weight,
                               cfg.noobj_weight, cfg.wh_weight)
        return main + JLoss.l2_penalty(p)

    grads = jax.jit(jax.grad(loss_fn))(state.params, state.batch_stats,
                                       images, labels)
    step = JT.make_train_step(jnet, JSPEC, cfg, train_epoch_step=STEPS)
    logs = []
    for _ in range(STEPS):
        state, lg = step(state, images, labels)
        logs.append({"loss": float(lg["loss"])})
    return dict(grads=_jax_flat(jax.device_get(grads)), logs=logs,
                params=_jax_flat(jax.device_get(state.params)))


def test_sharded_step_matches_the_jax_sharded_step(world2):
    """(b) The port's dp=2 step against JAX's make_train_step on a dp=2
    mesh, with JAX's own batch-permutation control."""
    ref, ctl = _jax_run(dp=2), _jax_run(swapped=True)
    single = _jax_run()
    g_floor = max(_rel_l1(ctl["grads"], single["grads"]), 1e-6)
    p_floor = max(_rel_l1(ctl["params"], single["params"]), 1e-6)
    for s in world2:
        got = s["plain"]
        np.testing.assert_allclose(got["logs"][0]["loss"],
                                   ref["logs"][0]["loss"], rtol=1e-5)
        g_err = _rel_l1(got["grads"], ref["grads"])
        p_err = _rel_l1(_params(got["final"]), ref["params"])
        assert g_err < 10 * g_floor, (g_err, g_floor)
        assert p_err < 10 * p_floor, (p_err, p_floor)


def test_fused_step_slots_equal_the_single_process_slots(world2):
    """(c) With augment on and the global draws injected, each rank's
    preprocessed images and labels are the single-process batch's slots
    [lo, hi), exactly."""
    ref = _local("fused")
    for s in world2:
        lo, hi = s["slots"]
        for (images, labels), (want_i, want_l) in zip(s["fused"]["slots"],
                                                      ref["slots"]):
            np.testing.assert_array_equal(images, want_i[lo:hi])
            for lab, want in zip(labels, want_l):
                np.testing.assert_array_equal(lab, want[lo:hi])


def test_fused_trajectory_matches_the_single_process_one(world2):
    """(c) The 3-step trajectory with augment on, within 10x the control
    (the single process's preprocessed batches with their halves swapped,
    through the plain step)."""
    ref = _local("fused")
    floor = max(_rel_l1(_params(_fused_control(ref)), _params(ref["final"])),
                1e-6)
    for s in world2:
        got = s["fused"]
        np.testing.assert_allclose(got["logs"][0]["loss"],
                                   ref["logs"][0]["loss"], rtol=1e-5)
        err = _rel_l1(_params(got["final"]), _params(ref["final"]))
        assert err < 10 * floor, (err, floor)


def _fused_control(ref):
    """The final state of 3 plain steps on the single process's
    preprocessed batches, each with its halves swapped."""
    cfg = W._cfg(JOB)
    state = TT.create_train_state(W._net(JOB, TSPEC), cfg, "cpu")
    step = TT.make_train_step(TSPEC, cfg)
    for images, labels in ref["slots"]:
        state, _ = step(state, torch.from_numpy(images[SWAPPED]),
                        [torch.from_numpy(lab[SWAPPED]) for lab in labels])
    return W.snapshot(state)


def test_pruned_masks_are_replicated_and_match_the_single_process(world2):
    """(d) dp=2 with the pruning overlay: both ranks hold the same masks
    (checked bit for bit above), and they differ from the single process's
    by no more entries than 10x the control's flips (at least one)."""
    ref, ctl = _local("prune"), _local("prune", tuple(SWAPPED))
    masks = sorted(k for k in ref["final"] if k.startswith("mask/"))
    assert len(masks) > 10

    def flips(a):
        return sum(int((a[k] != ref["final"][k]).sum()) for k in masks)

    n_ctl = flips(ctl["final"])
    for s in world2:
        got = s["prune"]["final"]
        assert sorted(k for k in got if k.startswith("mask/")) == masks
        assert flips(got) <= 10 * max(n_ctl, 1), (flips(got), n_ctl)
        zero = np.mean(np.concatenate([1 - got[k].ravel() for k in masks]))
        assert zero == pytest.approx(
            np.mean(np.concatenate([1 - ref["final"][k].ravel()
                                    for k in masks])), abs=1e-3)
        _assert_within_control(s["prune"], ref, ctl)


def test_batchnorm_takes_the_global_moments_and_their_backward(world2):
    """(e) At dp=2 a BatchNorm's output, running statistics, input
    gradient and (summed) weight gradients are the whole batch's."""
    ref = _local("bn")
    tol = dict(rtol=1e-5, atol=1e-6)
    for s in world2:
        lo, hi = s["slots"]
        got = s["bn"]
        np.testing.assert_allclose(got["mean"], ref["mean"], **tol)
        np.testing.assert_allclose(got["var"], ref["var"], **tol)
        np.testing.assert_allclose(got["y"], ref["y"][lo:hi], **tol)
        np.testing.assert_allclose(got["x_grad"], ref["x_grad"][lo:hi], **tol)
        np.testing.assert_allclose(got["w_grad"], ref["w_grad"], **tol)
        np.testing.assert_allclose(got["b_grad"], ref["b_grad"], **tol)
    # the moments are the global ones, not rank 0's shard's own: from
    # zero, one call leaves (1 - 0.99) * mean in the running mean
    own = JOB["bn_x"][:BATCH // 2].mean(axis=(0, 2, 3))
    assert np.abs(own - world2[0]["bn"]["mean"] / 0.01).max() > 1e-3


def test_a_stop_on_one_rank_stops_every_rank_after_the_same_step(world2):
    """(f) Rank 1 is sent SIGTERM during step 2: both ranks return after
    step 2, and only rank 0 logs."""
    r0, r1 = (s["stop"] for s in world2)
    assert r0["step"] == r1["step"] == 2
    assert r1["lines"] == []
    assert r0["lines"][-1].startswith("interrupted")


def test_model_and_space_axes_are_refused(world2):
    """What the model axis refuses to train: a train-mode forward under
    Int8Act on a tp2 mesh, a serving mode, as JAX refuses it (every
    builder trains on both axes, the patches stem too:
    ``tests/test_torch_tpsp_*.py``).  ``recalibrate_batch_stats`` on an
    sp2 mesh no longer refuses (fault u): both ranks, each with the whole
    net on the whole batch, leave the same statistics."""
    for s in world2:
        assert "Int8Act is a serving-only" in s["model_error"]
        assert s["space_error"] == ""
        for name, (mean, var) in world2[0]["space_stats"].items():
            np.testing.assert_array_equal(s["space_stats"][name][0], mean)
            np.testing.assert_array_equal(s["space_stats"][name][1], var)


def test_init_world_joins_from_the_torchrun_environment(monkeypatch):
    """RANK / WORLD_SIZE / MASTER_* set: init_world joins over env:// (a
    one-rank gloo world on localhost) and returns the CPU."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="localhost", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    device = TP.init_world("cpu")
    try:
        assert device == torch.device("cpu")
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        mesh = TP.make_mesh(device_type="cpu")
        assert TP.slot_range(8, mesh) == (0, 8)
    finally:
        dist.destroy_process_group()


def test_init_world_needs_an_init_method_and_a_card_for_cuda(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="file:// URL"):
        TP.init_world("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TP.init_world("cuda", "file:///nonexistent/init")


@pytest.mark.slow
def test_dp4_sharded_step_matches_the_single_process_step(tmp_path):
    """(a) at dp=4: two images a rank."""
    seen = spawn_world(4, _job(full=False), tmp_path, target=W.run)
    ref, ctl = _local("plain"), _local("plain", tuple(SWAPPED))
    for s in seen:
        _assert_within_control(s["plain"], ref, ctl)
    _assert_replicated(seen, "plain")

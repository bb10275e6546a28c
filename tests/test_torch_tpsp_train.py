"""Training on the model and space axes (``make_train_step`` and ``fit`` on
a mesh with mp or sp above 1, ``parallel/sharded.py``) against the JAX
package's single-device step and its GSPMD step on the same mesh, at
``tests/test_parallel_equivalence.py``'s shapes: yolo_mobilev1 alpha 0.25,
64x64 input, B=8, 3 steps; and the collectives, BatchNorm's group rule and
the ranges alone.

One gloo world of four CPU ranks (``tests/torch_tpsp_worker.py``, which
imports no JAX) trains on dp2*tp2, dp2*sp2 and tp2*sp2 in turn; JAX's
sharded step runs on the first four of its virtual CPU devices.  The rule
is the JAX test's: the first step's loss to rtol 1e-5; the first step's
gradients and the parameters after 3 steps within 10x a batch-permutation
control (JAX's single-device step on the batch with its halves swapped),
worst leaf by relative L1; each step's loss within max(5e-3, 10x the
control's deviation).  What can be exact is held exactly: the halo and the
gathers against the whole tensor, and the state every rank holds after
``fit``.
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
from k210_yolo_framework_tpu_torch.ops import codec as TCodec
from k210_yolo_framework_tpu_torch.training import checkpoint as TC

import torch_parallel_train_worker as TW
import torch_tpsp_worker as W
from torch_parallel_worker import spawn_world
from torch_parity import jax_weights

torch.set_num_threads(1)

ANCHORS = np.array([[[0.7, 0.6], [0.5, 0.5], [0.4, 0.3]],
                    [[0.3, 0.3], [0.2, 0.2], [0.1, 0.1]]], np.float32)
SPEC_ARGS = ((64, 64), ((2, 2), (4, 4)), 4, ANCHORS)
JSPEC = JConfig.YoloSpec.create(*SPEC_ARGS)
TSPEC = TConfig.YoloSpec.create(*SPEC_ARGS)
BATCH, STEPS, LR = 8, 3, 1e-3
SWAPPED = np.r_[BATCH // 2:BATCH, 0:BATCH // 2]
MESHES = {"dp2tp2": (2, 2, 1), "dp2sp2": (2, 1, 2), "tp2sp2": (1, 2, 2)}
STOP_RANK = 3          # model rank 1, space rank 1 of tp2sp2


def _job():
    """test_parallel_equivalence._batch (2 boxes an image, images U(0, 1)),
    a host batch of 8 canvases for ``fit``, the collectives' and
    BatchNorm's inputs and the stopping rank."""
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
    return dict(
        model="yolo_mobilev1", alpha=0.25, spec_args=SPEC_ARGS, lr=LR,
        steps=STEPS, meshes=list(MESHES.values()),
        flat=jax_weights("yolo_mobilev1", (64, 64), 3, 4, alpha=0.25)[2],
        images=images, labels=labels,
        host=(canvases, hws, np.stack(padded).astype(np.float32),
              np.stack(valid)),
        coll_x=rng.standard_normal((2, 4, 6, 5)).astype(np.float32),
        coll_g=rng.standard_normal((2, 4, 6, 5)).astype(np.float32),
        bn_x=(rng.standard_normal((BATCH, 6, 6, 7)) * 2 + 1).astype(
            np.float32),
        bn_g=rng.standard_normal((BATCH, 6, 6, 7)).astype(np.float32),
        bn_scale=rng.uniform(0.5, 1.5, 6).astype(np.float32),
        bn_bias=rng.standard_normal(6).astype(np.float32),
        stop_rank=STOP_RANK)


JOB = _job()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return spawn_world(4, JOB, tmp_path_factory.mktemp("tpsp_train"),
                       target=W.train)


def _jax_flat(tree) -> dict:
    return {f"params/{_path_key(p)}": np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _jax_run(dims=None, swapped=False):
    """JAX's make_train_step on the job's batch, on one device (and the
    first step's gradient) or on a (dp, mp, sp) mesh of the first four CPU
    devices."""
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
    if dims is not None:
        mesh = jax_make_mesh(*dims, devices=jax.devices()[:4])
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

    out = {}
    if dims is None:
        out["grads"] = _jax_flat(jax.device_get(jax.jit(jax.grad(loss_fn))(
            state.params, state.batch_stats, images, labels)))
    step = JT.make_train_step(jnet, JSPEC, cfg, train_epoch_step=STEPS)
    losses = []
    for _ in range(STEPS):
        state, lg = step(state, images, labels)
        losses.append(float(lg["loss"]))
    return dict(out, losses=losses,
                params=_jax_flat(jax.device_get(state.params)))


def _params(snap) -> dict:
    return TC.flat_from_state_dict(
        {k[4:]: torch.from_numpy(v) for k, v in snap.items()
         if k.startswith("net/") and k.endswith(("weight", "bias"))})


def _assert_within_control(got, want):
    """The port's run ``got`` (a rank's) against the JAX run ``want`` by
    test_parallel_equivalence.py's rule (the gradients where ``want`` has
    them: the single-device run's)."""
    single, ctl = _jax_run(), _jax_run(swapped=True)
    losses = [lg["loss"] for lg in got["logs"]]
    np.testing.assert_allclose(losses[0], want["losses"][0], rtol=1e-5)
    g_floor = max(W.rel_l1(ctl["grads"], single["grads"]), 1e-6)
    p_floor = max(W.rel_l1(ctl["params"], single["params"]), 1e-6)
    if "grads" in want:
        g_err = W.rel_l1(got["grads"], want["grads"])
        assert g_err < 10 * g_floor, (g_err, g_floor)
    p_err = W.rel_l1(_params(got["final"]), want["params"])
    assert p_err < 10 * p_floor, (p_err, p_floor)
    ctl_dev = float(np.max(np.abs(np.asarray(ctl["losses"])
                                  - np.asarray(single["losses"]))
                           / np.asarray(single["losses"])))
    np.testing.assert_allclose(losses, want["losses"],
                               rtol=max(5e-3, 10 * ctl_dev))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_sp_step_matches_the_jax_single_device_step(world4, mesh):
    for s in world4:
        _assert_within_control(s["plain"][mesh], _jax_run())


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_sp_step_matches_the_jax_sharded_step(world4, mesh):
    want = _jax_run(MESHES[mesh])
    for s in world4:
        _assert_within_control(s["plain"][mesh], want)
    # every rank holds the same state and logs the same scalars
    r0 = world4[0]["plain"][mesh]
    for s in world4[1:]:
        got = s["plain"][mesh]
        for k in r0["final"]:
            np.testing.assert_array_equal(got["final"][k], r0["final"][k],
                                          err_msg=k)
        assert got["logs"] == r0["logs"]


def test_halo_exchange_and_gather_against_the_whole_tensor(world4):
    """tp2sp2: a rank's rows with their one-row halos are those rows of
    the zero-padded whole; the halo's backward gives each row the sum of
    the gradients of every window it lies in; the channel gather is the
    whole tensor, and its backward the gradient summed over the model
    group (each of its 2 ranks' sum(out * g)), this rank's slice."""
    x, g = JOB["coll_x"], JOB["coll_g"]
    h = x.shape[2]
    padded = np.pad(x, ((0, 0), (0, 0), (1, 1), (0, 0)))
    windows = np.zeros_like(g)
    for s in world4:
        lo, hi = s["collectives"]["rows"]
        windows[:, :, max(lo - 1, 0):min(hi + 1, h)] += \
            g[:, :, max(lo - 1, 0):min(hi + 1, h)]
    windows /= 2        # each space rank's window, once a model replica
    seen_rows = set()
    for s in world4:
        c = s["collectives"]
        lo, hi = c["rows"]
        seen_rows.add((lo, hi))
        np.testing.assert_array_equal(c["halo"], padded[:, :, lo:hi + 2])
        np.testing.assert_allclose(c["halo_grad"], windows[:, :, lo:hi],
                                   rtol=1e-6, atol=1e-6)
        clo, chi = c["channels"]
        np.testing.assert_array_equal(c["gathered"], x)
        np.testing.assert_allclose(c["gather_grad"], 2 * g[:, clo:chi],
                                   rtol=1e-6, atol=1e-6)
    assert seen_rows == {(0, 3), (3, 6)}


def test_batchnorm_group_follows_the_rows(world4):
    """dp2sp2: with a layer's rows split (moments over data x space) and
    whole (over data alone), a BatchNorm's output, running statistics,
    input gradient and (summed) weight gradients are the whole batch's;
    the moments are not a rank's own part's."""
    ref = TW.bn_moments(JOB)
    tol = dict(rtol=1e-5, atol=1e-6)
    for s in world4:
        for case in ("split", "whole"):
            got = s["bn"][case]
            lo, hi = got["slots"]
            rlo, rhi = got["rows"]
            np.testing.assert_allclose(got["mean"], ref["mean"], **tol)
            np.testing.assert_allclose(got["var"], ref["var"], **tol)
            np.testing.assert_allclose(got["y"], ref["y"][lo:hi, :, rlo:rhi],
                                       **tol)
            np.testing.assert_allclose(got["x_grad"],
                                       ref["x_grad"][lo:hi, :, rlo:rhi],
                                       **tol)
            np.testing.assert_allclose(got["w_grad"], ref["w_grad"], **tol)
            np.testing.assert_allclose(got["b_grad"], ref["b_grad"], **tol)
        lo, hi = s["bn"]["split"]["slots"]
        rlo, rhi = s["bn"]["split"]["rows"]
        own = JOB["bn_x"][lo:hi, :, rlo:rhi].mean(axis=(0, 2, 3))
        assert np.abs(own - s["bn"]["split"]["mean"] / 0.01).max() > 1e-3


def test_row_and_channel_ranges(world4):
    """tp2sp2: rows split where H divides by sp, else whole; channels split
    where the kernel is marked (divides by mp, at least 128), else
    whole."""
    for rank, s in enumerate(world4):
        m, sp_rank = divmod(rank, 2)
        rows, channels = s["ranges"]["rows"], s["ranges"]["channels"]
        assert rows[8] == (4 * sp_rank, 4 * sp_rank + 4)
        assert rows[2] == (sp_rank, sp_rank + 1)
        assert rows[7] == (0, 7) and rows[1] == (0, 1)
        assert channels[256] == (128 * m, 128 * m + 128)
        assert channels[128] == (64 * m, 64 * m + 64)
        assert channels[129] == (0, 129) and channels[96] == (0, 96)


def test_tp_sp_fit_leaves_the_state_equal_on_every_rank(world4):
    """tp2sp2, 3 steps with pruning and augment on and a validation step:
    parameters, BN statistics, Adam moments, masks, counters and step
    count bit for bit the same on every rank; world rank 0 alone logs,
    the validation line among its lines."""
    r0 = world4[0]["fit"]["final"]
    assert r0["step"] == STEPS
    assert any(k.startswith("mask/") for k in r0)
    assert any(k.startswith("adam/") for k in r0)
    for s in world4[1:]:
        got = s["fit"]["final"]
        assert sorted(got) == sorted(r0)
        for k in r0:
            np.testing.assert_array_equal(got[k], r0[k], err_msg=k)
        assert s["fit"]["lines"] == []
    assert "val_loss" in world4[0]["fit"]["lines"][-1]


def test_a_stop_on_a_model_or_space_rank_stops_every_rank(world4):
    """Rank 3 (model rank 1, space rank 1) is sent SIGTERM during step 2:
    every rank returns after step 2, and only world rank 0 logs."""
    stops = [s["stop"] for s in world4]
    assert [st["step"] for st in stops] == [2] * 4
    assert all(st["lines"] == [] for st in stops[1:])
    assert stops[0]["lines"][-1].startswith("interrupted")


def test_what_the_axes_do_not_train_yet_refuses(world4):
    """On tp2*sp2 a train-mode forward under Int8Act refuses (it is a
    serving mode, as in JAX); the patches stem, which this mesh used to
    refuse, runs a train-mode forward whose heads are one process's on the
    whole batch (BatchNorm's moments summed over data x space in another
    order: measured 1.4e-5 at worst, held at 1e-4);
    ``recalibrate_batch_stats`` on dp2*sp2 runs (fault u) and leaves the
    same statistics on every rank, moved from the drawn ones."""
    r0 = world4[0]["recalibrated"]
    drawn = TW._net(JOB, TW._spec(JOB)).state_dict()
    assert all(not np.allclose(mean, drawn[f"{name}.running_mean"])
               for name, (mean, _) in r0.items())
    net = TW._net(JOB, TW._spec(JOB))
    net.stem_mode = "patches"
    with torch.no_grad():
        heads = net(W.stem_patches(torch.from_numpy(JOB["images"])))
    for s in world4:
        assert "Int8Act is a serving-only" in s["train_int8_error"]
        for got, want in zip(s["patches_heads"], heads):
            np.testing.assert_allclose(got, want.numpy(), rtol=1e-4,
                                       atol=1e-4)
        for name, (mean, var) in r0.items():
            np.testing.assert_array_equal(s["recalibrated"][name][0], mean)
            np.testing.assert_array_equal(s["recalibrated"][name][1], var)

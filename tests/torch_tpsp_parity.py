"""The JAX side of the TP/SP builder tests (``tests/test_torch_tpsp_
mobilev2.py``, ``_tiny.py``, ``_yolo.py``): one builder at a small input,
its job for the four-rank gloo world (``tests/torch_tpsp_worker.py::
builder``, which imports no JAX), and the JAX references it is held to.

A :class:`Case` names the builder, its width multiplier, the input and grid
sizes, and the serving and training batches.  :func:`references` runs, once
per test module, JAX's single-device serving program (``_run_batch``), its
train step and first-step gradient, both again on the batch with its
halves swapped (the permutation control of
``tests/test_parallel_equivalence.py``), and JAX's GSPMD programs on a
(dp, mp, sp) mesh of the first four CPU devices.  The world gets the
references' parameters and gradients as flat float32 files it memory-maps
(:func:`write_flat`), so a rank returns rel-L1 errors and a digest of its
state, not the darknet53 yolo's 62M parameters.

Training is held on the smooth witness (``layers.smooth_witness`` and
:func:`smooth_jax`: every kink and max-pool smoothed).  The nets
themselves are badly conditioned at their seeded weights: on tiny_yolo a
pool window whose two largest values lie within rounding sends a
gradient to another element between two programs, so the port's own
single-process step lands 0.031 (relative L1) from JAX's first-step
gradient and its fp32 TP/SP step 0.097 from JAX's GSPMD parameters after
3 steps, and JAX's GSPMD step is 0.5% from its single-device one in the
second step's loss, where the permutation control (2.6e-5, 0.0036) keeps
every pool's argmax.  On the witness the port's single-process gradient
lies within the control (9.6e-5 against 1.1e-4).  The nets' own train
step is held by its first-step loss.

The bounds are the JAX tests': serving at ``tests/test_sharded_serving.py``
's (``valid`` equal, scores rtol 1e-4 / atol 1e-5, at most 0.5% of the
detections unmatched either way, matched scores within 1e-3), training at
``tests/test_parallel_equivalence.py``'s (the first step's loss to rtol
1e-5; the first step's gradients and the parameters after the steps within
10x the permutation control, worst leaf by relative L1; each step's loss
within max(5e-3, 10x the control's deviation)).  The worst leaf is taken
over the leaves whose gradient is not at rounding level: a BatchNorm bias
whose every path to the loss runs through a 1x1 conv and a train-mode BN
(yolo_mobilev2's linear project BNs) has an exact gradient of 0, so its
relative L1 is noise against noise (about 1.5 between JAX's two orders),
and Adam moves it by +-lr on that noise.  Those leaves are picked by the
reference gradient (below ``VANISHING`` of the largest entry) and held to
stay there, on JAX's side and on the port's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
from pathlib import Path
from unittest import mock

import numpy as np
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from k210_yolo_framework_tpu import config as JConfig
from k210_yolo_framework_tpu.inference import Predictor as JaxPredictor
from k210_yolo_framework_tpu.models import darknet as JD
from k210_yolo_framework_tpu.models import layers as JL
from k210_yolo_framework_tpu.models import mobilenet_v2 as JV2
from k210_yolo_framework_tpu.parallel import batch_sharding, image_sharding
from k210_yolo_framework_tpu.parallel import make_mesh as jax_make_mesh
from k210_yolo_framework_tpu.training import loss as JLoss
from k210_yolo_framework_tpu.training import metrics as JM
from k210_yolo_framework_tpu.training import pruning as JP
from k210_yolo_framework_tpu.training import train as JT
from k210_yolo_framework_tpu.training.checkpoint import _path_key
from k210_yolo_framework_tpu.utils.detmatch import match_stats
from k210_yolo_framework_tpu_torch import config as TConfig
from k210_yolo_framework_tpu_torch.ops import codec as TCodec
from k210_yolo_framework_tpu_torch.ops.nms import NmsResult

import torch_tpsp_worker as W
from torch_parallel_worker import spawn_world
from torch_parity import jax_weights
from torch_tpsp_worker import leaf_rel_l1

MESHES = {"dp2tp2": (2, 2, 1), "dp2sp2": (2, 1, 2), "tp2sp2": (1, 2, 2)}
GSPMD = "tp2sp2"           # the mesh also held to JAX's GSPMD programs
THRESH = dict(obj_thresh=0.05, iou_thresh=0.45)
LR = 1e-3
# a gradient leaf whose largest entry lies below this share of the largest
# gradient entry is at rounding level (torch_parity.assert_train_mode_close)
VANISHING = 1e-6


@dataclasses.dataclass(frozen=True)
class Case:
    """One builder at one size: ``out_hws`` its grids (coarsest first),
    ``anchors`` [layers, 3, 2]; ``serve_batch`` canvases served (in fp32,
    and in each of the ``quantized`` configurations),
    ``train_batch`` images trained on for ``steps`` steps."""
    model: str
    alpha: float
    in_hw: tuple
    out_hws: tuple
    anchors: tuple
    serve_batch: int = 8
    train_batch: int = 8
    steps: int = 3
    class_num: int = 5
    quantized: tuple = ()     # torch_tpsp_worker.QUANTIZED names served too
    # the int8-activation flip bound against JAX (assert_quantized_alike)
    act_bound: tuple = (0.01, 2e-3)

    @property
    def spec_args(self):
        return (self.in_hw, self.out_hws, self.class_num,
                np.asarray(self.anchors, np.float32))

    def weights(self):
        return jax_weights(self.model, self.in_hw, 3, self.class_num,
                           alpha=self.alpha)


def _canvases(case: Case):
    """Serving canvases whose images' letterbox scales into the input are
    exact (1 or 2: ROADMAP fault q)."""
    rng = np.random.default_rng(1)
    h, w = case.in_hw
    hws = np.array([[h, w], [h // 2, w // 2], [h, w // 2], [h // 2, w]]
                   * (case.serve_batch // 4), np.int32)
    canvases = np.zeros((case.serve_batch, h, w, 3), np.uint8)
    for i, (a, b) in enumerate(hws):
        canvases[i, :a, :b] = rng.integers(0, 256, (a, b, 3))
    return canvases, hws


def _train_batch(case: Case):
    """test_parallel_equivalence._batch at the case's size: 2 boxes an
    image, images U(0, 1), labels encoded by the port."""
    rng = np.random.default_rng(0)
    b = case.train_batch
    boxes = np.concatenate([
        rng.integers(0, case.class_num, (b, 2, 1)).astype(np.float32),
        rng.uniform(0.2, 0.8, (b, 2, 2)),
        rng.uniform(0.2, 0.5, (b, 2, 2))], -1).astype(np.float32)
    labels = [lab.numpy() for lab in TCodec.encode_labels_batch(
        torch.from_numpy(boxes), torch.ones(b, 2, dtype=torch.bool),
        TConfig.YoloSpec.create(*case.spec_args))]
    images = rng.uniform(0, 1, (b, *case.in_hw, 3)).astype(np.float32)
    return images, labels


def swapped(case: Case) -> np.ndarray:
    b = case.train_batch
    return np.r_[b // 2:b, 0:b // 2]


def make_job(case: Case, **extra) -> dict:
    """The world's job: weights (native flat dict), the serving canvases,
    the train batch, the meshes, and the case flags ``extra``."""
    canvases, hws = _canvases(case)
    images, labels = _train_batch(case)
    return dict(model=case.model, alpha=case.alpha,
                spec_args=case.spec_args, flat=case.weights()[2],
                canvases=canvases, hws=hws, predictor=THRESH,
                images=images, labels=labels, lr=LR, steps=case.steps,
                meshes=list(MESHES.values()), quantized=case.quantized,
                **extra)


# ---- JAX's programs ------------------------------------------------------

def _jax_predictor(case: Case, cfg=None):
    """JAX's Predictor of ``case``, in the ``W.QUANTIZED`` configuration
    ``cfg`` (None: fp32, the default stem)."""
    quantize, stem_mode = W.QUANTIZED[cfg] if cfg else (None, "default")
    jnet, variables, _ = case.weights()
    return JaxPredictor(jnet, dict(variables),
                        JConfig.YoloSpec.create(*case.spec_args),
                        compute_dtype=jnp.float32, quantize=quantize,
                        stem_mode=stem_mode, **THRESH)


def _served(case: Case, dims=None, cfg=None) -> NmsResult:
    canvases, hws = _canvases(case)
    jp = _jax_predictor(case, cfg)
    if dims is None:
        res = jp._run_batch(jp.variables, jnp.asarray(canvases),
                            jnp.asarray(hws))
    else:
        mesh = jax_make_mesh(*dims, devices=jax.devices()[:4])
        res = jp.make_sharded_runner(mesh)(jnp.asarray(canvases),
                                           jnp.asarray(hws))
    return NmsResult(*(np.asarray(t) for t in res))


def _flat(tree) -> dict:
    return {f"params/{_path_key(p)}": np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_state(case: Case, cfg):
    _, variables, _ = case.weights()
    params = jax.tree.map(jnp.copy, variables["params"])
    return JT.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.copy, variables["batch_stats"]),
        opt_state=JT.make_optimizer(cfg).init(params),
        masks=JP.init_masks(params), pr=JM.init_pr_state(len(case.out_hws)))


def _trained(case: Case, step, order, mesh=None):
    """``case.steps`` steps of the jitted JAX step on the batch in
    ``order``: (losses, final parameters)."""
    images, labels = _train_batch(case)
    cfg = JConfig.TrainConfig(batch_size=case.train_batch,
                              init_learning_rate=LR)
    state = _jax_state(case, cfg)
    x = jnp.asarray(images[order])
    y = tuple(jnp.asarray(lab[order]) for lab in labels)
    if mesh is not None:
        state = JT.shard_state(state, mesh)
        x = jax.device_put(x, image_sharding(mesh))
        y = tuple(jax.device_put(lab, batch_sharding(mesh)) for lab in y)
    losses = []
    for _ in range(case.steps):
        state, lg = step(state, x, y)
        losses.append(float(lg["loss"]))
    return losses, _flat(jax.device_get(state.params))


@contextlib.contextmanager
def smooth_jax():
    """The JAX package's side of ``layers.smooth_witness(net)`` while JAX
    traces: its ``leaky_relu(a)`` and MobileNetV2's ``relu6`` (a = 0) as
    a * x + (1 - a) * softplus(x), tiny_yolo's max-pools as log-sum-exp
    over each SAME window (the pad adding exp(-inf) = 0)."""
    def pool(x, stride):
        return jnp.log(nn.avg_pool(jnp.exp(x), (2, 2), (stride, stride),
                                   padding="SAME",
                                   count_include_pad=True) * 4)

    with mock.patch.object(JL, "leaky_relu", lambda a: (
            lambda x: a * x + (1 - a) * jax.nn.softplus(x))), \
            mock.patch.object(JV2, "relu6", jax.nn.softplus), \
            mock.patch.object(JD, "_maxpool", pool):
        yield


def _jax_train(case: Case) -> dict:
    """On the smooth witness (:func:`smooth_jax`): JAX's single-device step
    on the batch and on its swapped halves (one compiled program), the
    first step's gradient on each, and the GSPMD step on
    ``MESHES[GSPMD]``; and the net's own (kinked) first-step loss."""
    jnet, variables, _ = case.weights()
    spec = JConfig.YoloSpec.create(*case.spec_args)
    cfg = JConfig.TrainConfig(batch_size=case.train_batch,
                              init_learning_rate=LR)
    images, labels = _train_batch(case)

    def main_loss(p, bs, x, lab):
        outs, _ = jnet.apply({"params": p, "batch_stats": bs}, x, train=True)
        return JLoss.yolo_loss(lab, outs, spec, case.train_batch,
                               cfg.obj_thresh, cfg.iou_thresh,
                               cfg.obj_weight, cfg.noobj_weight,
                               cfg.wh_weight)

    def batch(order):
        return (jnp.asarray(images[order]),
                tuple(jnp.asarray(lab[order]) for lab in labels))

    out = {"kinked_loss": float(jax.jit(main_loss)(
        variables["params"], variables["batch_stats"],
        *batch(np.arange(case.train_batch))))}
    with smooth_jax():
        grad = jax.jit(jax.grad(
            lambda p, bs, x, lab: main_loss(p, bs, x, lab)
            + JLoss.l2_penalty(p)))
        step = JT.make_train_step(jnet, spec, cfg,
                                  train_epoch_step=case.steps)
        for name, order in (("single", np.arange(case.train_batch)),
                            ("control", swapped(case))):
            g = grad(variables["params"], variables["batch_stats"],
                     *batch(order))
            losses, params = _trained(case, step, order)
            out[name] = dict(grads=_flat(jax.device_get(g)), losses=losses,
                             params=params)
        mesh = jax_make_mesh(*MESHES[GSPMD], devices=jax.devices()[:4])
        losses, params = _trained(case, step, np.arange(case.train_batch),
                                  mesh)
    out["gspmd"] = dict(losses=losses, params=params)
    return out


def worst_leaf(errors: dict, vanishing) -> float:
    """The largest of ``errors`` (leaf -> rel-L1) outside ``vanishing``."""
    return max(e for k, e in errors.items() if k not in vanishing)


@functools.lru_cache(maxsize=None)
def references(case: Case) -> dict:
    """Every JAX reference of ``case`` (module docstring), its serving in
    each ``case.quantized`` configuration among them; cached.
    ``vanishing`` lists the leaves whose first-step gradient is at rounding
    level on JAX's single-device step, ``grad_top`` is that gradient's
    largest entry."""
    train = _jax_train(case)
    single, ctl = train["single"], train["control"]
    top = max(float(np.abs(g).max()) for g in single["grads"].values())
    vanishing = sorted(k for k, g in single["grads"].items()
                       if np.abs(g).max() <= VANISHING * top)
    # only a BatchNorm's shift can be removed downstream
    assert all(k.endswith("/bn/bias") for k in vanishing), vanishing
    for k in vanishing:
        assert np.abs(ctl["grads"][k]).max() <= VANISHING * top, k
    ctl_dev = float(np.max(np.abs(np.asarray(ctl["losses"])
                                  - np.asarray(single["losses"]))
                           / np.asarray(single["losses"])))

    def worst(a, b):
        return worst_leaf(leaf_rel_l1(a, b), vanishing)

    return dict(
        served=_served(case), served_gspmd=_served(case, MESHES[GSPMD]),
        quantized={cfg: _served(case, cfg=cfg) for cfg in case.quantized},
        train=train, vanishing=vanishing, grad_top=top,
        floors=dict(grads=max(worst(ctl["grads"], single["grads"]), 1e-6),
                    params=max(worst(ctl["params"], single["params"]), 1e-6),
                    losses=max(5e-3, 10 * ctl_dev),
                    # JAX's own GSPMD step from its single-device one
                    gspmd_params=worst(train["gspmd"]["params"],
                                       single["params"])))


def write_flat(tmp: Path, name: str, flat: dict) -> None:
    """``flat`` as one float32 file ``<name>.npy`` and its index
    ``<name>.json`` (key -> offset, shape), for ``read_flat``."""
    index, offset = {}, 0
    for k in sorted(flat):
        index[k] = (offset, list(np.shape(flat[k])))
        offset += int(np.size(flat[k]))
    np.save(tmp / f"{name}.npy", np.concatenate(
        [np.asarray(flat[k], np.float32).ravel() for k in sorted(flat)]))
    # the index last, whole: a rank waiting for it then reads both
    (tmp / f"{name}.json.part").write_text(json.dumps(index))
    (tmp / f"{name}.json.part").replace(tmp / f"{name}.json")


REFERENCE_FILES = {"grads": ("single", "grads"),
                   "params": ("single", "params"),
                   "gspmd_params": ("gspmd", "params")}


def spawn_builder_world(case: Case, tmp: Path, **extra) -> list:
    """The four-rank world of ``torch_tpsp_worker.builder`` on ``case``'s
    job (with the flags ``extra``); JAX's references are computed while
    the ranks serve and train, and written for them (:func:`write_flat`)
    under ``tmp``."""
    def write_references():
        train = references(case)["train"]
        for stem, (run, what) in REFERENCE_FILES.items():
            write_flat(tmp, stem, train[run][what])

    job = make_job(case, refs={s: str(tmp / s) for s in REFERENCE_FILES},
                   **extra)
    return spawn_world(4, job, tmp, timeout=900.0, target=W.builder,
                       meanwhile=write_references)


# ---- the bounds -----------------------------------------------------------

def assert_served_alike(got: NmsResult, want: NmsResult) -> None:
    """test_sharded_serving.py:93-105's bounds."""
    assert [g.shape for g in got] == [w.shape for w in want]
    np.testing.assert_array_equal(got.valid, want.valid)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-4,
                               atol=1e-5)
    un_ab, n_a, ds_ab = match_stats(want, got)
    un_ba, n_b, ds_ba = match_stats(got, want)
    assert n_a > 0
    assert un_ab <= max(1, int(np.ceil(0.005 * n_a))), (un_ab, n_a)
    assert un_ba <= max(1, int(np.ceil(0.005 * n_b))), (un_ba, n_b)
    assert max(ds_ab, ds_ba) <= 1e-3, (ds_ab, ds_ba)


def assert_quantized_alike(cfg: str, got: NmsResult, want: NmsResult,
                           bound=(0.01, 2e-3)) -> None:
    """A ``W.QUANTIZED`` configuration's result against JAX's: at
    :func:`assert_served_alike`'s bounds, or in the int8-activation modes
    at ``bound``, (the share of the detections unmatched either way, the
    largest matched score difference), with and without a score tolerance
    of 0.05 on a match: JAX's float path and the port's differ by ulps,
    which now and then flips an activation's rounding, and a flip moves
    every later layer.  Each caller pins ``bound`` at the flip rate it
    measured, never past JAX's own 10% (``tests/test_sharded_serving.py::
    test_sharded_int8_act_runner_matches_local``)."""
    if W.QUANTIZED[cfg][0] not in ("int8_act", "int8_act_sym",
                                   "int8_act_cal"):
        assert_served_alike(got, want)
        return
    unmatched, score = bound
    assert unmatched <= 0.1
    for tol in (None, 0.05):
        un_ab, n_a, ds_ab = match_stats(want, got, score_tol=tol)
        un_ba, n_b, ds_ba = match_stats(got, want, score_tol=tol)
        assert n_a > 0 and n_b > 0
        assert un_ab <= unmatched * n_a, (un_ab, n_a)
        assert un_ba <= unmatched * n_b, (un_ba, n_b)
        assert max(ds_ab, ds_ba) <= score, (ds_ab, ds_ba)


@functools.lru_cache(maxsize=None)
def port_served(case: Case, cfg: str) -> NmsResult:
    """The port's single-process ``_run_batch`` of ``case``'s serving batch
    in the ``W.QUANTIZED`` configuration ``cfg``; cached."""
    job = make_job(case)
    res = W.quantized_predictor(job, *W.QUANTIZED[cfg])._run_batch(
        torch.from_numpy(job["canvases"]), torch.from_numpy(job["hws"]))
    return NmsResult(*(t.numpy() for t in res))


def assert_trained_alike(got: dict, case: Case, gspmd: bool = False) -> None:
    """A rank's run (``torch_tpsp_worker._held_steps``'s record) against
    JAX's single-device step, or with ``gspmd`` its GSPMD step, by
    test_parallel_equivalence.py's rule on the smooth witness (the worst
    leaf outside ``vanishing``, whose gradients stay at rounding level);
    the net's own first-step loss against JAX's (kinked, single-device) to
    rtol 1e-5."""
    ref = references(case)
    want = ref["train"]["gspmd" if gspmd else "single"]
    floors, vanishing = ref["floors"], ref["vanishing"]
    np.testing.assert_allclose(got["kinked"]["logs"][0]["loss"],
                               ref["train"]["kinked_loss"], rtol=1e-5)
    got = got["smooth"]
    losses = [lg["loss"] for lg in got["logs"]]
    # against the GSPMD step the bars lie past JAX's own distance from its
    # single-device step
    single = ref["train"]["single"]["losses"][0]
    own = abs(want["losses"][0] - single) / abs(single)
    np.testing.assert_allclose(losses[0], want["losses"][0],
                               rtol=1e-5 + own)
    if not gspmd:
        for k in vanishing:
            assert got["grads_max"][k] <= VANISHING * ref["grad_top"], k
        err = worst_leaf(got["grads_err"], vanishing)
        assert err < 10 * floors["grads"], (err, floors["grads"])
    err = worst_leaf(got["gspmd_params_err" if gspmd else "params_err"],
                     vanishing)
    bar = 10 * floors["params"] + (floors["gspmd_params"] if gspmd else 0)
    assert err < bar, (err, floors)
    np.testing.assert_allclose(losses, want["losses"], rtol=floors["losses"])


def assert_ranks_agree(runs) -> None:
    """Every rank holds the same state after the steps (the smooth
    witness's and the net's) and logs the same scalars."""
    for run in runs:
        for kind in ("smooth", "kinked"):
            assert run[kind]["digest"] == runs[0][kind]["digest"], kind
            assert run[kind]["logs"] == runs[0][kind]["logs"], kind

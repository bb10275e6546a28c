"""Serving on the model and space axes (``Predictor.make_sharded_runner`` on
a mesh with mp or sp above 1, ``parallel/sharded.py``) against the JAX
package's single-device program and its GSPMD program on the same mesh,
after ``tests/test_sharded_serving.py::
test_model_axis_sharded_serving_matches_local``: yolo_mobilev1 alpha 1.0
(kernels of 128 channels and more exist to shard) at 96x96, B=8.

One gloo world of four CPU ranks (``tests/torch_tpsp_worker.py``, which
imports no JAX) serves the batch on dp2*tp2, dp2*sp2 and tp2*sp2 in turn;
JAX's sharded runner runs on the first four of its virtual CPU devices.
Tolerances are the JAX test's: ``valid`` equal, scores rtol 1e-4 / atol
1e-5, at most 0.5% of the detections unmatched either way and matched
scores within 1e-3 (a TP or SP program reorders the reductions the
single-device program makes).  The canvases hold images whose letterbox
scale into 96x96 is exact (ROADMAP fault q: JAX's jitted letterbox departs
from the eager one elsewhere).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from k210_yolo_framework_tpu import config as JConfig
from k210_yolo_framework_tpu.inference import Predictor as JaxPredictor
from k210_yolo_framework_tpu.parallel import make_mesh as jax_make_mesh
from k210_yolo_framework_tpu.parallel.mesh import (
    param_shardings as jax_param_shardings,
)
from k210_yolo_framework_tpu.training.checkpoint import _path_key
from k210_yolo_framework_tpu_torch.ops.nms import NmsResult
from k210_yolo_framework_tpu_torch.training import checkpoint as TC

import torch_tpsp_worker as W
from torch_parallel_worker import spawn_world
from torch_parity import jax_weights
from torch_tpsp_parity import assert_served_alike

torch.set_num_threads(1)

ANCHORS = np.array([[[0.7, 0.6], [0.5, 0.5], [0.4, 0.3]],
                    [[0.3, 0.3], [0.2, 0.2], [0.15, 0.15]]], np.float32)
SPEC_ARGS = ((96, 96), ((3, 3), (6, 6)), 5, ANCHORS)
JSPEC = JConfig.YoloSpec.create(*SPEC_ARGS)
MESHES = {"dp2tp2": (2, 2, 1), "dp2sp2": (2, 1, 2), "tp2sp2": (1, 2, 2)}
THRESH = dict(obj_thresh=0.05, iou_thresh=0.45)
B = 8


def _job():
    rng = np.random.default_rng(1)
    hws = np.array([[96, 96], [48, 48], [96, 48], [48, 96]] * (B // 4),
                   np.int32)
    canvases = np.zeros((B, 96, 96, 3), np.uint8)
    for i, (h, w) in enumerate(hws):
        canvases[i, :h, :w] = rng.integers(0, 256, (h, w, 3))
    _, _, flat = jax_weights("yolo_mobilev1", (96, 96), 3, 5, alpha=1.0)
    return dict(model="yolo_mobilev1", alpha=1.0, spec_args=SPEC_ARGS,
                flat=flat, canvases=canvases, hws=hws, predictor=THRESH,
                meshes=list(MESHES.values()))


JOB = _job()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return spawn_world(4, JOB, tmp_path_factory.mktemp("tpsp_serve"),
                       target=W.serve)


def _jax_predictor():
    jnet, variables, _ = jax_weights("yolo_mobilev1", (96, 96), 3, 5,
                                     alpha=1.0)
    return JaxPredictor(jnet, dict(variables), JSPEC,
                        compute_dtype=jnp.float32, **THRESH)


def _jax_local():
    jp = _jax_predictor()
    res = jp._run_batch(jp.variables, jnp.asarray(JOB["canvases"]),
                        jnp.asarray(JOB["hws"]))
    return NmsResult(*(np.asarray(t) for t in res))


def _jax_sharded(dims):
    mesh = jax_make_mesh(*dims, devices=jax.devices()[:4])
    res = _jax_predictor().make_sharded_runner(mesh)(
        jnp.asarray(JOB["canvases"]), jnp.asarray(JOB["hws"]))
    return NmsResult(*(np.asarray(t) for t in res))


@pytest.fixture(scope="module")
def jax_local():
    return _jax_local()


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_sp_runner_matches_the_jax_single_device_program(world4, mesh,
                                                            jax_local):
    """Every rank returns the whole batch's result."""
    assert int(jax_local.valid.sum()) > 20
    for s in world4:
        assert_served_alike(NmsResult(*s["results"][mesh]), jax_local)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_sp_runner_matches_the_jax_sharded_program(world4, mesh):
    want = _jax_sharded(MESHES[mesh])
    for s in world4:
        assert_served_alike(NmsResult(*s["results"][mesh]), want)


def test_tensor_parallelism_engages(world4):
    """On the meshes with a model axis the port shards the kernels JAX's
    rule shards (by the weight bridge's names), and the two model ranks
    compute the two halves of each one's output channels."""
    jnet, variables, _ = jax_weights("yolo_mobilev1", (96, 96), 3, 5,
                                     alpha=1.0)
    specs = jax_param_shardings(variables["params"],
                                jax_make_mesh(2, 2, 1,
                                              devices=jax.devices()[:4]))
    want = sorted("params/" + _path_key(p) for p, s in
                  jax.tree_util.tree_flatten_with_path(specs)[0]
                  if "model" in str(s.spec))
    assert len(want) > 5
    for mesh in ("dp2tp2", "tp2sp2"):
        _, mp, sp = MESHES[mesh]
        for rank, s in enumerate(world4):
            ranges = s["ranges"][mesh]
            assert sorted(TC.native_key(n, 4) for n in ranges) == want
            m = (rank // sp) % mp
            for name, (lo, hi) in ranges.items():
                whole = JOB["flat"][TC.native_key(name, 4)].shape[-1]
                assert (lo, hi) == (m * whole // 2, (m + 1) * whole // 2)
    # without a model axis nothing is marked
    assert all(s["ranges"]["dp2sp2"] == {} for s in world4)


def test_what_the_axes_do_not_serve_yet_refuses(world4):
    """What is left to refuse on tp2*sp2 is a train-mode forward under
    Int8Act (a serving mode, as in JAX).  The ``int8`` and ``patches``
    Predictors it used to refuse serve there, each rank's result the same
    Predictor's single-process ``_run_batch`` at the JAX test's bounds
    (every quantize and stem mode: ``tests/test_torch_tpsp_quantize.py``)."""
    for s in world4:
        assert "Int8Act is a serving-only" in s["train_int8_error"]
        assert sorted(s["served_on_tpsp"]) == ["int8", "patches"]
        for got, want in s["served_on_tpsp"].values():
            assert_served_alike(NmsResult(*got), NmsResult(*want))

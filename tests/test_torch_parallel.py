"""The port's device mesh and data-parallel serving (``parallel/mesh.py``,
``Predictor.make_sharded_runner``) against the JAX package's, after
``tests/test_sharded_serving.py``.

The port runs one process a device, so its mesh needs a process group:
here gloo worlds of CPU processes (``torch.multiprocessing`` spawn,
``file://`` init), each rank in ``tests/torch_parallel_worker.py``, which
imports no JAX.  Tolerances: the sharded result on every rank against
JAX's single-device ``_run_batch`` at ``test_sharded_serving.py``'s
(``valid`` equal, scores rtol 1e-5 / atol 1e-6, boxes rtol 1e-4 / atol
1e-3), and against the port's own single-process ``_run_batch`` at the
same tolerances (a rank's shard of 8 images takes other CPU conv blocking
than the batch of 16: boxes move by ulps); ``int8_act`` at set level
(each shard quantizes with its own range, as each JAX shard does).
"""

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import jax
import jax.numpy as jnp

from k210_yolo_framework_tpu import config as JConfig
from k210_yolo_framework_tpu.inference import Predictor as JaxPredictor
from k210_yolo_framework_tpu.parallel import make_mesh as jax_make_mesh
from k210_yolo_framework_tpu.parallel.mesh import (
    param_shardings as jax_param_shardings,
)
from k210_yolo_framework_tpu.training.checkpoint import _path_key
from k210_yolo_framework_tpu.utils.detmatch import match_stats
from k210_yolo_framework_tpu_torch import parallel as TP
from k210_yolo_framework_tpu_torch.ops.nms import NmsResult
from k210_yolo_framework_tpu_torch.training import checkpoint as TC

import torch_parallel_worker as W
from torch_parity import jax_weights

torch.set_num_threads(1)

ANCHORS = np.array([[[0.7, 0.6], [0.5, 0.5], [0.4, 0.3]],
                    [[0.3, 0.3], [0.2, 0.2], [0.15, 0.15]]], np.float32)
SPEC_ARGS = ((64, 64), ((2, 2), (4, 4)), 4, ANCHORS)
JSPEC = JConfig.YoloSpec.create(*SPEC_ARGS)
THRESH = dict(obj_thresh=0.05, iou_thresh=0.45)


def _scene(seed, b):
    """Canvases of 64x64 holding images whose letterbox scale into 64x64
    is exact (ROADMAP fault q: the JAX Predictor's jitted letterbox departs
    from the eager one elsewhere)."""
    rng = np.random.default_rng(seed)
    hws = np.array([[64, 64], [32, 32], [64, 32], [32, 64]] * (b // 4),
                   np.int32)
    canvases = np.zeros((b, 64, 64, 3), np.uint8)
    for i, (h, w) in enumerate(hws):
        canvases[i, :h, :w] = rng.integers(0, 256, (h, w, 3))
    return canvases, hws


def _job(b, seed, **predictor):
    _, _, flat = jax_weights("yolo_mobilev1", (64, 64), 3, 4, alpha=0.5)
    canvases, hws = _scene(seed, b)
    return dict(model="yolo_mobilev1", alpha=0.5, spec_args=SPEC_ARGS,
                flat=flat, canvases=canvases, hws=hws,
                predictor={**THRESH, **predictor})


def _jax_local(job):
    jnet, variables, _ = jax_weights("yolo_mobilev1", (64, 64), 3, 4,
                                     alpha=0.5)
    jp = JaxPredictor(jnet, dict(variables), JSPEC, compute_dtype=jnp.float32,
                      **job["predictor"])
    res = jp._run_batch(jp.variables, jnp.asarray(job["canvases"]),
                        jnp.asarray(job["hws"]))
    return [np.asarray(t) for t in res]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """One gloo world of two ranks: the mesh rules, the runner on B=16
    (rank 1's stem kernel put off by one first), a batch of 15, and a mesh
    with a model axis."""
    job = _job(16, seed=0)
    job["model_axis"] = True
    job["perturbed_rank"] = 1
    seen = W.spawn_world(2, job, tmp_path_factory.mktemp("world2"))
    return job, seen


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        TP.make_mesh(device_type="cpu")


def test_mesh_shapes_placements_and_the_size_error(world2):
    _, seen = world2
    for s in seen:
        assert s["shape"] == (2, 1, 1)
        assert s["names"] == ("data", "model", "space")
        assert s["size_error"] == "dp*mp*sp = 3*1*1 != 2 devices"
        assert s["placements"]["batch"] == (Shard(0), Replicate(), Replicate())
        # sp == 1: images shard like any batch
        assert s["placements"]["image"] == s["placements"]["batch"]
        assert s["placements"]["replicated"] == (Replicate(),) * 3
        assert s["space_image"] == (Shard(0), Replicate(), Shard(1))


def test_param_shardings_mark_what_jax_marks(world2):
    """At mp=2 the port shards the kernels JAX shards, by the weight
    bridge's names (out channels: dim 0 of OIHW, the last of HWIO)."""
    _, seen = world2
    jnet, variables, _ = jax_weights("yolo_mobilev1", (64, 64), 3, 4,
                                     alpha=0.5)
    specs = jax_param_shardings(variables["params"],
                                jax_make_mesh(dp=4, mp=2))
    want = sorted(
        "params/" + _path_key(p) for p, s in
        jax.tree_util.tree_flatten_with_path(specs)[0]
        if "model" in str(s.spec))
    assert len(want) > 5
    for s in seen:
        got = sorted(TC.native_key(name, 4) for name in s["model_marked"])
        assert got == want


def test_sharded_runner_matches_the_jax_local_program(world2):
    """Every rank returns the whole batch's result, equal to JAX's
    single-device program and to the port's own at JAX's sharded-serving
    tolerances."""
    job, seen = world2
    local = W.port_local(job)
    assert local[3].sum() > 20
    for want in (_jax_local(job), local):
        for s in seen:
            got = s["result"]
            assert [g.shape for g in got] == [w.shape for w in want]
            np.testing.assert_array_equal(got[3], want[3])
            np.testing.assert_array_equal(got[2], want[2])
            np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-3)


def test_sharded_runner_replicates_rank_0s_weights(world2):
    """Rank 1 made its Predictor with a stem kernel off by one; the runner
    broadcasts rank 0's weights, so its result above is rank 0's too."""
    _, (r0, r1) = world2
    np.testing.assert_array_equal(r1["stem_before"], r0["stem_before"] + 1)
    for s in (r0, r1):
        np.testing.assert_array_equal(s["stem_after"], r0["stem_before"])


def test_sharded_runner_refuses_a_batch_the_data_axis_does_not_divide(
        world2):
    _, seen = world2
    for s in seen:
        assert s["odd_error"] == ("batch 15 does not divide by the data "
                                  "axis's size 2")


def test_model_axis_mesh_is_not_served_yet(world2):
    """An int8 Predictor, which a tp2 mesh used to refuse, serves there:
    every rank's result is the same Predictor's single-process
    ``_run_batch`` at this file's tolerances (every quantize mode on the
    model and space axes: ``tests/test_torch_tpsp_quantize.py``)."""
    _, seen = world2
    for s in seen:
        got, want = s["model_int8"]
        assert want[3].sum() > 20
        np.testing.assert_array_equal(got[3], want[3])
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-3)


@pytest.mark.slow
def test_sharded_int8_act_runner_matches_local(tmp_path):
    """int8_act on four ranks: each shard quantizes with its own dynamic
    range, as each JAX shard does, so the detection sets agree with JAX's
    single-device program for the overwhelming majority (the JAX test's
    bounds: score within 0.05, at most 10% unmatched either way)."""
    job = _job(16, seed=2, quantize="int8_act")
    seen = W.spawn_world(4, job, tmp_path)
    local = NmsResult(*_jax_local(job))
    for s in seen:
        got = NmsResult(*s["result"])
        un_ab, n_a, _ = match_stats(local, got, score_tol=0.05)
        un_ba, n_b, _ = match_stats(got, local, score_tol=0.05)
        assert n_a > 0
        assert un_ab / n_a <= 0.1, (un_ab, n_a)
        assert un_ba / max(n_b, 1) <= 0.1, (un_ba, n_b)

"""tiny_yolo on the model and space axes: served
(``Predictor.make_sharded_runner``, in fp32 and ``int8_act``) and
trained (``make_train_step``) on a mesh with mp or sp above 1, against the JAX package's single-device
programs and, on tp2*sp2, its GSPMD programs (``tests/
torch_tpsp_parity.py``: the bounds of ``tests/test_sharded_serving.py`` and
``tests/test_parallel_equivalence.py``); the sharded SAME pools alone; and
``recalibrate_batch_stats(mesh=)`` on a TP/SP mesh (ROADMAP fault u).

At 128x128 the stride-32 grid has 4 rows, so over sp = 2 the stride-1
pool before ``conv_6`` pools split rows and takes one row of the next
space rank below, -inf past the last (at 224x320 its 7 rows are gathered
and the halo never runs); every stride-2 pool splits without a halo.  B=8
served and trained for 3 steps.  One gloo world of four CPU ranks
(``tests/torch_tpsp_worker.py::builder``) runs dp2*tp2, dp2*sp2 and
tp2*sp2 in turn, then the pools on tp2*sp2 and the recalibration on
dp2*sp2 and tp2*sp2.
"""

import functools

import numpy as np
import pytest
import torch

from k210_yolo_framework_tpu_torch.data import pipeline as PL
from k210_yolo_framework_tpu_torch.models.layers import BatchNorm
from k210_yolo_framework_tpu_torch.ops import codec as TCodec
from k210_yolo_framework_tpu_torch.ops.nms import NmsResult
from k210_yolo_framework_tpu_torch.training import train as TT

import torch_parallel_train_worker as TW
import torch_tpsp_parity as P
import torch_tpsp_worker as W

torch.set_num_threads(1)

CASE = P.Case("tiny_yolo", 1.0, (128, 128), ((4, 4), (8, 8)),
              (((0.7, 0.6), (0.5, 0.5), (0.4, 0.3)),
               ((0.3, 0.3), (0.2, 0.2), (0.15, 0.15))),
              quantized=("int8_act",), act_bound=(0.01, 0.03))


def _hosts():
    """Two host batches of 4 canvases (144x160, images of any size in
    them) with 1-3 boxes each, for the recalibration."""
    rng = np.random.default_rng(4)
    hosts = []
    for _ in range(2):
        hws = np.stack([rng.integers(60, 145, 4), rng.integers(60, 161, 4)],
                       -1).astype(np.int32)
        canvases = np.zeros((4, 144, 160, 3), np.uint8)
        padded, valid = [], []
        for i, (h, w) in enumerate(hws):
            canvases[i, :h, :w] = rng.integers(0, 256, (h, w, 3))
            nb = int(rng.integers(1, 4))
            b, v = TCodec.pad_boxes(np.hstack([
                rng.integers(0, 5, (nb, 1)).astype(float),
                rng.uniform(0.2, 0.8, (nb, 2)),
                rng.uniform(0.1, 0.4, (nb, 2))]))
            padded.append(b)
            valid.append(v)
        hosts.append((canvases, hws, np.stack(padded).astype(np.float32),
                      np.stack(valid)))
    return hosts


def _extra():
    rng = np.random.default_rng(5)
    return dict(
        pools=True, recalibrate=True, recal_hosts=_hosts(),
        # negative everywhere: a zero pad would win every window it is in
        pool_x=-(np.abs(rng.standard_normal((2, 3, 8, 5))) + 0.5).astype(
            np.float32),
        pool_g=rng.standard_normal((2, 3, 8, 5)).astype(np.float32))


EXTRA = _extra()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return P.spawn_builder_world(
        CASE, tmp_path_factory.mktemp("tpsp_tiny"), **EXTRA)


@pytest.mark.parametrize("mesh", list(P.MESHES))
def test_tp_sp_runner_matches_the_jax_single_device_program(world4, mesh):
    """Every rank returns the whole batch's result."""
    want = P.references(CASE)["served"]
    assert int(want.valid.sum()) > 20
    for s in world4:
        P.assert_served_alike(NmsResult(*s["results"][mesh]), want)


def test_tp_sp_runner_matches_the_jax_sharded_program(world4):
    want = P.references(CASE)["served_gspmd"]
    for s in world4:
        P.assert_served_alike(NmsResult(*s["results"][P.GSPMD]), want)


@pytest.mark.parametrize("mesh", list(P.MESHES))
@pytest.mark.parametrize("cfg", CASE.quantized)
def test_quantized_runner_matches_the_jax_single_device_program(world4, cfg,
                                                                mesh):
    """``int8_act`` (the dense convs int8 between the sharded SAME
    max-pools, the stride-1 pool's -inf halo among them): against the
    port's own single-process program at the fp32 bounds (measured: no
    flip, scores within 6e-8), and against JAX's single-device program at
    its pinned flip bound (``torch_tpsp_parity.assert_quantized_alike``):
    10 of 1,200 detections unmatched each way, matched scores within
    0.0288 on every mesh, the port's single-process distance from JAX;
    held at 1% and 0.03."""
    want = P.references(CASE)["quantized"][cfg]
    own = P.port_served(CASE, cfg)
    for s in world4:
        got = NmsResult(*s["results"][(mesh, cfg)])
        P.assert_served_alike(got, own)
        P.assert_quantized_alike(cfg, got, want, CASE.act_bound)


@pytest.mark.parametrize("mesh", list(P.MESHES))
def test_tp_sp_step_matches_the_jax_single_device_step(world4, mesh):
    """Every rank's step against JAX's; every rank holds the same state and
    logs the same scalars.  No gradient leaf is at rounding level."""
    assert P.references(CASE)["vanishing"] == []
    runs = [s["train"][mesh] for s in world4]
    for run in runs:
        P.assert_trained_alike(run, CASE)
    P.assert_ranks_agree(runs)


def test_tp_sp_step_matches_the_jax_sharded_step(world4):
    for s in world4:
        P.assert_trained_alike(s["train"][P.GSPMD], CASE, gspmd=True)


@pytest.mark.parametrize("pool", list(W.POOLS))
@pytest.mark.parametrize("case", W.POOL_CASES,
                         ids=[f"h{h}s{s}{'split' if p else 'whole'}"
                              for h, s, p in W.POOL_CASES])
def test_sharded_pool_equals_the_whole_pool(world4, case, pool):
    """tp2sp2, negative content (a zero pad would win every window it is
    in): ``torch_tpsp_worker.assert_pools_whole``."""
    W.assert_pools_whole(world4, EXTRA, case, pool)


@functools.lru_cache(maxsize=None)
def _recalibrated_alone():
    spec = TW._spec(P.make_job(CASE))
    net = TW._net(P.make_job(CASE), spec)
    TT.recalibrate_batch_stats(
        net, iter([PL.HostBatch(*h) for h in EXTRA["recal_hosts"]]),
        PL.make_preprocess_fn(spec, False),
        num_batches=len(EXTRA["recal_hosts"]), device="cpu")
    return {name: (m.running_mean.numpy(), m.running_var.numpy())
            for name, m in net.named_modules() if isinstance(m, BatchNorm)}


@pytest.mark.parametrize("mesh", ["dp2sp2", "tp2sp2"])
def test_recalibration_on_a_tp_sp_mesh_equals_one_process(world4, mesh):
    """Fault u: on a mesh with a model or space axis every rank
    recalibrates with the whole net on its data slots, the moments over
    the data axis: every BatchNorm's statistics are the single-process
    recalibration's (the JAX package's, ``tests/
    test_torch_recalibrate.py``) on every rank; on tp2*sp2 (dp = 1) each
    rank's batch is the whole batch."""
    want = _recalibrated_alone()
    tol = dict(rtol=1e-5, atol=1e-6) if mesh == "dp2sp2" \
        else dict(rtol=0, atol=0)
    for s in world4:
        got = s["recalibrated"][mesh]
        assert sorted(got) == sorted(want)
        for name, (mean, var) in want.items():
            np.testing.assert_allclose(got[name][0], mean, **tol,
                                       err_msg=name)
            np.testing.assert_allclose(got[name][1], var, **tol,
                                       err_msg=name)

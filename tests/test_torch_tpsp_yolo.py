"""The darknet53 yolo on the model and space axes: served
(``Predictor.make_sharded_runner``, in fp32 and ``int8_act``) and
trained (``make_train_step``) on a mesh with mp or sp above 1, against the JAX package's single-device
programs and, on tp2*sp2, its GSPMD programs (``tests/
torch_tpsp_parity.py``: the bounds of ``tests/test_sharded_serving.py`` and
``tests/test_parallel_equivalence.py``).

At 64x64 its grids 2x2, 4x4 and 8x8 all split over sp = 2, so the
stride-2 convs padded top/left only take a one-row halo above, every
residual add and both concats (``Yolo._heads``) see split rows, and at
tp2 the 128- to 1024-channel stages are channel slices.  Serving B=8,
training B=4 for 3 steps (the darknet53 yolo's 62M parameters make a
step the file's cost).  One gloo world of four CPU ranks
(``tests/torch_tpsp_worker.py::builder``) runs dp2*tp2, dp2*sp2 and
tp2*sp2 in turn.
"""

import pytest
import torch

from k210_yolo_framework_tpu_torch.ops.nms import NmsResult

import torch_tpsp_parity as P

torch.set_num_threads(1)

CASE = P.Case("yolo", 1.0, (64, 64), ((2, 2), (4, 4), (8, 8)),
              (((0.7, 0.6), (0.5, 0.5), (0.4, 0.3)),
               ((0.3, 0.3), (0.2, 0.2), (0.15, 0.15)),
               ((0.1, 0.1), (0.08, 0.06), (0.05, 0.05))),
              serve_batch=8, train_batch=4, quantized=("int8_act",),
              act_bound=(0.09, 0.045))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return P.spawn_builder_world(
        CASE, tmp_path_factory.mktemp("tpsp_yolo"))


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
    """``int8_act`` (the dense convs int8 around the sliced and split
    residual adds and both concats): against the port's own
    single-process program at the fp32 bounds (measured: no flip, scores
    within 7.2e-7), and against JAX's single-device program at its pinned
    flip bound (``torch_tpsp_parity.assert_quantized_alike``): 103 of
    1,200 detections unmatched each way (8.6%), matched scores within
    0.0414 on every mesh, the port's single-process distance from JAX
    (72 int8 convs deep, each flip moves every later layer); held at 9%
    and 0.045, inside JAX's own 10%."""
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

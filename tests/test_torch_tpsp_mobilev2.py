"""yolo_mobilev2 (alpha 1.0) on the model and space axes: served
(``Predictor.make_sharded_runner``, in fp32, ``int8_act`` and the
``patches`` stem) and trained (``make_train_step``) on a
mesh with mp or sp above 1, against the JAX package's single-device
programs and, on tp2*sp2, its GSPMD programs (``tests/
torch_tpsp_parity.py``: the bounds of ``tests/test_sharded_serving.py`` and
``tests/test_parallel_equivalence.py``); and the sharded residual add
alone.

At alpha 1.0 the 160-channel blocks 14-15 are sliced over ``model`` (at
0.75 they have 120 channels and never are), so their residual adds add
channel slices; at 96x96 the adds of blocks 2-12 add split rows.  B=8
served and trained for 3 steps.  One gloo world of four CPU ranks
(``tests/torch_tpsp_worker.py::builder``) runs dp2*tp2, dp2*sp2 and
tp2*sp2 in turn, then the adds on tp2*sp2.
"""

import itertools

import numpy as np
import pytest
import torch

from k210_yolo_framework_tpu_torch.ops.nms import NmsResult

import torch_tpsp_parity as P

torch.set_num_threads(1)

CASE = P.Case("yolo_mobilev2", 1.0, (96, 96), ((3, 3), (6, 6)),
              (((0.7, 0.6), (0.5, 0.5), (0.4, 0.3)),
               ((0.3, 0.3), (0.2, 0.2), (0.15, 0.15))),
              quantized=("int8_act", "patches"), act_bound=(0.025, 5e-3))
LAYOUTS = list(itertools.product((False, True), repeat=2))   # rows, chans


def _extra():
    rng = np.random.default_rng(6)
    a, b, g = (rng.standard_normal((1, 128, 4, 3)).astype(np.float32)
               for _ in range(3))
    return dict(adds=True, add_a=a, add_b=b, add_g=g)


EXTRA = _extra()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return P.spawn_builder_world(
        CASE, tmp_path_factory.mktemp("tpsp_v2"), **EXTRA)


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
    """``int8_act`` (the dense convs of the inverted residuals int8 around
    sliced and split residual adds) and the ``patches`` stem: against the
    port's own single-process program at the fp32 bounds (measured: no
    flip, scores equal), and against JAX's single-device program, the
    patches at the fp32 bounds (2.7e-7) and ``int8_act`` at its pinned
    flip bound (``torch_tpsp_parity.assert_quantized_alike``): 29 of 1,200
    detections unmatched each way and matched scores within 4.8e-3 on
    every mesh, the port's single-process distance from JAX exactly;
    held at 2.5% and 5e-3."""
    want = P.references(CASE)["quantized"][cfg]
    own = P.port_served(CASE, cfg)
    for s in world4:
        got = NmsResult(*s["results"][(mesh, cfg)])
        P.assert_served_alike(got, own)
        P.assert_quantized_alike(cfg, got, want, CASE.act_bound)


@pytest.mark.parametrize("mesh", list(P.MESHES))
def test_tp_sp_step_matches_the_jax_single_device_step(world4, mesh):
    """Every rank's step against JAX's; every rank holds the same state and
    logs the same scalars.  The leaves held at rounding level are the 17
    linear project BNs' biases, and only they."""
    assert P.references(CASE)["vanishing"] == sorted(
        f"params/backbone/block_{i}/project/bn/bias" for i in range(17))
    runs = [s["train"][mesh] for s in world4]
    for run in runs:
        P.assert_trained_alike(run, CASE)
    P.assert_ranks_agree(runs)


def test_tp_sp_step_matches_the_jax_sharded_step(world4):
    for s in world4:
        P.assert_trained_alike(s["train"][P.GSPMD], CASE, gspmd=True)


def _ids(layout):
    rows, channels = layout
    return f"{'rowcut' if rows else 'rows'}-{'chcut' if channels else 'ch'}"


@pytest.mark.parametrize("other", LAYOUTS, ids=_ids)
@pytest.mark.parametrize("fresh", LAYOUTS, ids=_ids)
def test_sharded_add_cuts_the_whole_side(world4, fresh, other):
    """tp2sp2, 128 channels and 4 rows: the sum holds the more cut of the
    two layouts on each axis and equals that part of a + b; each side's
    gradient is the incoming gradient scattered into its own layout (zero
    where the cut dropped it); without gradients the sum is written into
    ``fresh`` alone."""
    a, b, g = EXTRA["add_a"], EXTRA["add_b"], EXTRA["add_g"]
    layout = (fresh[0] or other[0], fresh[1] or other[1])
    for s in world4:
        (rlo, rhi), (clo, chi) = s["adds"]["rows"], s["adds"]["channels"]
        assert (rhi - rlo, chi - clo) == (2, 64)

        def part(t, rows, channels):
            t = t[:, clo:chi] if channels else t
            return t[:, :, rlo:rhi] if rows else t

        rec = s["adds"]["cases"][(fresh, other)]
        assert rec["layout"] == layout
        np.testing.assert_array_equal(rec["y"], part(a + b, *layout))
        scattered = np.zeros_like(g)
        rows = slice(rlo, rhi) if layout[0] else slice(None)
        chans = slice(clo, chi) if layout[1] else slice(None)
        scattered[:, chans, rows] = g[:, chans, rows]
        np.testing.assert_array_equal(rec["fresh_grad"],
                                      part(scattered, *fresh))
        np.testing.assert_array_equal(rec["other_grad"],
                                      part(scattered, *other))
        assert rec["no_grad_equal"] and rec["into_fresh"]
        assert rec["other_untouched"]

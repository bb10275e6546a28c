"""Quantized serving and the patches stem on the model and space axes
(``Predictor.make_sharded_runner`` on a mesh with mp or sp above 1 in every
quantize mode and stem mode) against the JAX package's single-device
program and its GSPMD program, and the sharded int8 conv alone against the
port's own on the whole tensor.

One gloo world of four CPU ranks (``tests/torch_tpsp_worker.py::
quantized``, which imports no JAX) runs dp2*tp2, dp2*sp2 and tp2*sp2 in
turn, then ``int8_act`` on the pure data-parallel mesh of the four; JAX's
programs run in this process meanwhile, its GSPMD ones (every
configuration but ``nativeconv``) on tp2*sp2 over the first four of its
virtual CPU devices.

* The int8 conv (1x1; 3x3 SAME, which reads ``zp`` past every edge; the
  3x3 stride-2 stem of three channels padded by 1, as ``nativeconv``
  quantizes it) in the affine, symmetric and calibrated modes, on inputs
  one data shard and one row half of which are four times the rest:
  gathered, bit for bit ``Conv.forward_int8`` of the whole tensor (the
  range is an exact max, the halo copies values, the int32 sums are exact
  in any order).  Ranges taken over a rank's own part alone do not match
  where the parts' ranges differ.
* yolo_mobilev1 alpha 1.0 at 96x96, B=8, obj_thresh 0.27 (60% of the
  1,200 slots valid; at 0.05 every slot is), served in ``int8``,
  ``int8_act``, ``int8_act_sym``, ``int8_act_cal``, ``patches``,
  ``patches`` + ``int8`` and ``nativeconv`` + ``int8_act``.  ``int8`` and
  both ``patches`` configurations at ``tests/test_sharded_serving.py``'s
  bounds (``valid`` equal, scores rtol 1e-4 / atol 1e-5, at most 0.5%
  unmatched either way, matched scores within 1e-3; measured 1.5e-7).  The
  int8-activation modes at their measured flip rate, pinned at its
  ceiling: against JAX's single-device program 0, 3 (``int8_act_sym``), 0
  and 0 of 720 detections unmatched each way, 1 and 2 of 721 against
  JAX's GSPMD ``int8_act_sym``, matched scores within 1.52e-3 (JAX's float
  path and the port's differ by ulps, which flips an activation rounding
  now and then); held at 1% unmatched each way and 2e-3, within JAX's own
  ``test_sharded_int8_act_runner_matches_local`` (10% at score_tol 0.05).
  Every rank returns the same result.
* ``int8_act_cal``: world rank 0 calibrates on one scene, ranks 1-2 on
  another, rank 3 not at all; every rank serves rank 0's ranges bit for
  bit.  JAX is calibrated on rank 0's scene.
* The TP/SP runner quantizes with the whole global batch's range; the pure
  data-parallel runner with each shard's own, as JAX's ``shard_map``
  does.  The all-reduces a call: none in ``int8``, ``int8_act_cal`` and the
  float stem modes; one a quantized conv whose input is spread over ranks
  in the dynamic modes.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from k210_yolo_framework_tpu import config as JConfig
from k210_yolo_framework_tpu.inference import Predictor as JaxPredictor
from k210_yolo_framework_tpu.parallel import make_mesh as jax_make_mesh
from k210_yolo_framework_tpu_torch.ops.nms import NmsResult

import torch_tpsp_worker as W
from torch_parallel_worker import spawn_world
from torch_parity import jax_weights
from torch_tpsp_parity import assert_quantized_alike, assert_served_alike

torch.set_num_threads(1)

ANCHORS = np.array([[[0.7, 0.6], [0.5, 0.5], [0.4, 0.3]],
                    [[0.3, 0.3], [0.2, 0.2], [0.15, 0.15]]], np.float32)
SPEC_ARGS = ((96, 96), ((3, 3), (6, 6)), 5, ANCHORS)
JSPEC = JConfig.YoloSpec.create(*SPEC_ARGS)
MESHES = {"dp2tp2": (2, 2, 1), "dp2sp2": (2, 1, 2), "tp2sp2": (1, 2, 2)}
THRESH = dict(obj_thresh=0.27, iou_thresh=0.45)
B = 8
# the configurations also held to JAX's GSPMD program: every quantize mode
# and the patches stem (nativeconv's stem is held by the single-device one)
GSPMD_CONFIGS = tuple(c for c in W.QUANTIZED if c != "nativeconv_int8_act")
# the dense convs of yolo_mobilev1 that compute int8 (13 pointwise, 3 in
# the head; ``nativeconv`` adds the stem)
INT8_CONVS = 16


def _scene(seed):
    """B canvases of 96x96 holding images whose letterbox scale into 96x96
    is exact (ROADMAP fault q)."""
    rng = np.random.default_rng(seed)
    hws = np.array([[96, 96], [48, 48], [96, 48], [48, 96]] * (B // 4),
                   np.int32)
    canvases = np.zeros((B, 96, 96, 3), np.uint8)
    for i, (h, w) in enumerate(hws):
        canvases[i, :h, :w] = rng.integers(0, 256, (h, w, 3))
    return canvases, hws


def _conv_inputs():
    """Each ``W.INT8_CONVS`` kind's global input [4, cin, 8, 6] (data
    shard 1's bottom rows four times the rest; the stem's an image whose
    first data shard is a quarter as bright), kernel [136, cin, kh, kw]
    (136 channels: a model rank's 68 are no multiple of 8) and calibrated
    range (narrower than the data: it clips)."""
    rng = np.random.default_rng(7)
    xs, ws, static = {}, {}, {}
    for kind, (cin, kernel, _, _) in W.INT8_CONVS.items():
        if kind == "stem":
            x = rng.integers(0, 256, (4, cin, 8, 6)).astype(np.float32)
            x[:2] = np.floor(x[:2] / 4)
            static[kind] = (0.0, 200.0)
        else:
            x = rng.standard_normal((4, cin, 8, 6)).astype(np.float32)
            x[2:, :, 4:] *= 4
            static[kind] = (-2.5, 3.0)
        xs[kind] = x
        ws[kind] = (rng.standard_normal((136, cin, *kernel))
                    * 0.1).astype(np.float32)
    return xs, ws, static


def _job():
    canvases, hws = _scene(1)
    _, _, flat = jax_weights("yolo_mobilev1", (96, 96), 3, 5, alpha=1.0)
    xs, ws, static = _conv_inputs()
    return dict(model="yolo_mobilev1", alpha=1.0, spec_args=SPEC_ARGS,
                flat=flat, canvases=canvases, hws=hws, predictor=THRESH,
                meshes=list(MESHES.values()), calib=_scene(3),
                calib_other=_scene(4), conv_x=xs, conv_w=ws,
                conv_static=static)


JOB = _job()


@functools.lru_cache(maxsize=None)
def _jax_served(cfg: str, dims=None) -> NmsResult:
    """JAX's single-device ``_run_batch`` (``dims`` None) or its sharded
    runner on the (dp, mp, sp) mesh ``dims`` in configuration ``cfg``."""
    quantize, stem_mode = W.QUANTIZED[cfg]
    jnet, variables, _ = jax_weights("yolo_mobilev1", (96, 96), 3, 5,
                                     alpha=1.0)
    jp = JaxPredictor(jnet, dict(variables), JSPEC, compute_dtype=jnp.float32,
                      quantize=quantize, stem_mode=stem_mode, **THRESH)
    if quantize == "int8_act_cal":
        jp.calibrate(*JOB["calib"])
    c, h = jnp.asarray(JOB["canvases"]), jnp.asarray(JOB["hws"])
    if dims is None:
        res = jp._run_batch(jp.variables, c, h)
    else:
        res = jp.make_sharded_runner(
            jax_make_mesh(*dims, devices=jax.devices()[:4]))(c, h)
    return NmsResult(*(np.asarray(t) for t in res))


def _jax_references():
    for cfg in W.QUANTIZED:
        _jax_served(cfg)
    for cfg in GSPMD_CONFIGS:
        _jax_served(cfg, MESHES["tp2sp2"])


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return spawn_world(4, JOB, tmp_path_factory.mktemp("tpsp_quantize"),
                       timeout=900.0, target=W.quantized,
                       meanwhile=_jax_references)


def _whole_conv(kind: str, mode: str) -> np.ndarray:
    conv = W.int8_conv(JOB, kind)
    with torch.no_grad():
        return conv.forward_int8(torch.from_numpy(JOB["conv_x"][kind]),
                                 W.INT8_ACTS[mode]).numpy()


@pytest.mark.parametrize("mode", list(W.INT8_ACTS))
@pytest.mark.parametrize("kind", list(W.INT8_CONVS))
def test_sharded_int8_conv_is_the_whole_tensors_bit_for_bit(world4, kind,
                                                           mode):
    """On every mesh and rank, gathered whole, the sharded int8 conv equals
    ``forward_int8`` of the global tensor; its output holds this rank's
    rows where sp splits them and its channels where mp slices them.  With
    the range taken over the rank's own part alone it does not equal it
    where that part's range differs (dynamic modes: every mesh for the
    128-channel inputs, whose rows or data shards differ; the stem, whose
    rows every rank holds whole, where dp > 1), and does where no range is
    reduced (the calibrated mode)."""
    want = _whole_conv(kind, mode)
    for mesh, (dp, mp, sp) in MESHES.items():
        for s in world4:
            rec = s["convs"][mesh][(kind, mode)]
            np.testing.assert_array_equal(rec["y"], want)
            assert rec["layout"] == (sp > 1, mp > 1)
            spread = kind != "stem" or dp > 1
            assert np.array_equal(rec["own"], want) == (
                mode == "static" or not spread), (mesh, kind, mode)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("cfg", list(W.QUANTIZED))
def test_quantized_runner_matches_the_jax_single_device_program(world4, cfg,
                                                                mesh):
    """Every rank returns the whole batch's result, the same on every rank
    (module docstring's bounds); 20-90% of the slots are valid."""
    want = _jax_served(cfg)
    assert 0.2 * want.valid.size < want.valid.sum() < 0.9 * want.valid.size
    _assert_alike(cfg, [NmsResult(*s["served"][(mesh, cfg)]["result"])
                        for s in world4], want)


@functools.lru_cache(maxsize=None)
def _port_served(cfg: str) -> NmsResult:
    """The port's single-process ``_run_batch`` in configuration ``cfg``
    (``int8_act_cal`` calibrated on rank 0's scene)."""
    quantize, stem_mode = W.QUANTIZED[cfg]
    pred = W.quantized_predictor(JOB, quantize, stem_mode)
    if quantize == "int8_act_cal":
        pred.calibrate(*JOB["calib"])
    res = pred._run_batch(torch.from_numpy(JOB["canvases"]),
                          torch.from_numpy(JOB["hws"]))
    return NmsResult(*(t.numpy() for t in res))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("cfg", list(W.QUANTIZED))
def test_quantized_runner_matches_the_ports_single_process_program(
        world4, cfg, mesh):
    """Every configuration, the int8-activation modes too, at
    test_sharded_serving.py's bounds against the port's own single-process
    program: the whole batch's ranges make the sharded program that
    program (measured: no flip; scores equal in the int8-activation modes,
    within 8.9e-8 in ``int8``)."""
    for s in world4:
        assert_served_alike(NmsResult(*s["served"][(mesh, cfg)]["result"]),
                            _port_served(cfg))


@pytest.mark.parametrize("cfg", GSPMD_CONFIGS)
def test_quantized_runner_matches_the_jax_sharded_program(world4, cfg):
    want = _jax_served(cfg, MESHES["tp2sp2"])
    _assert_alike(cfg, [NmsResult(*s["served"][("tp2sp2", cfg)]["result"])
                        for s in world4], want)


def _assert_alike(cfg, ranks, want):
    """Every rank's result the same; against ``want`` at
    test_sharded_serving.py's bounds, or in the int8-activation modes at
    the pinned flip bound (``torch_tpsp_parity.assert_quantized_alike``)."""
    for got in ranks[1:]:
        for a, b in zip(got, ranks[0]):
            np.testing.assert_array_equal(a, b)
    assert_quantized_alike(cfg, ranks[0], want)


def test_every_rank_serves_rank_0s_calibrated_ranges(world4):
    """Rank 0 calibrated on one scene, ranks 1-2 on another (their own
    ranges differ from rank 0's), rank 3 not at all: once the runner is
    made, every rank holds rank 0's ranges bit for bit, on every mesh."""
    for mesh in MESHES:
        own = [s["served"][(mesh, "int8_act_cal")]["own_ranges"]
               for s in world4]
        assert len(own[0]) == INT8_CONVS and own[3] == {}
        assert own[1] == own[2] and own[1] != own[0]
        for s in world4:
            assert s["served"][(mesh, "int8_act_cal")]["served_ranges"] \
                == own[0]


def _local_ranges(canvases, hws):
    """The ranges each int8 conv of the port's single-process
    ``int8_act`` Predictor takes on ``canvases``, by scope."""
    pred = W.quantized_predictor(JOB, "int8_act", "default")
    _, ranges, reduces = W.recorded(lambda: pred._run_batch(
        torch.from_numpy(canvases), torch.from_numpy(hws)))
    assert reduces == 0 and len(ranges) == INT8_CONVS
    return {scope: (lo, hi) for scope, lo, hi in ranges}


def test_the_tp_sp_runner_quantizes_with_the_whole_batchs_range(world4):
    """``int8_act``: every rank of every TP/SP mesh takes, for each int8
    conv, the range the single-process program takes on the whole batch
    (to rtol 1e-5: the float layers before it run on slices and may move
    by ulps), which each data shard's own range is not; the pure
    data-parallel runner takes each rank's shard's own range exactly, as
    JAX's ``shard_map`` does."""
    whole = _local_ranges(JOB["canvases"], JOB["hws"])
    shards = [_local_ranges(JOB["canvases"][2 * r:2 * r + 2],
                            JOB["hws"][2 * r:2 * r + 2]) for r in range(4)]
    for sh in shards:
        assert any(not np.allclose(sh[k], whole[k], rtol=1e-3)
                   for k in whole)
    for mesh in MESHES:
        for s in world4:
            got = s["served"][(mesh, "int8_act")]["ranges"]
            assert [scope for scope, _, _ in got] == list(whole)
            for scope, lo, hi in got:
                np.testing.assert_allclose((lo, hi), whole[scope], rtol=1e-5)
    for r, s in enumerate(world4):
        got = {scope: (lo, hi) for scope, lo, hi in s["dp"]["ranges"]}
        assert got == shards[r]
        assert got != whole


@pytest.mark.parametrize("cfg", list(W.QUANTIZED))
def test_range_all_reduces_a_call(world4, cfg):
    """One max all-reduce a call for each int8 conv whose input is spread
    over ranks in the dynamic modes: every one on a mesh with a data axis
    (its batch is spread), those whose rows are split on tp2*sp2 (12 of
    16; at dp = 1 a whole-row input is every rank's whole), and none on a
    model axis alone; none at all in ``int8``, ``int8_act_cal`` and the
    float stem modes."""
    quantize, stem_mode = W.QUANTIZED[cfg]
    dynamic = quantize in ("int8_act", "int8_act_sym")
    n_int8 = INT8_CONVS + (stem_mode == "nativeconv")
    want = {"dp2tp2": n_int8, "dp2sp2": n_int8, "tp2sp2": 12}
    for mesh in MESHES:
        for s in world4:
            got = s["served"][(mesh, cfg)]["all_reduces"]
            assert got == (want[mesh] if dynamic else 0), (mesh, got)

"""The port's export (``export.py``, ``cli/keras_freeze``'s library half)
against its eager programs and the JAX package's export.

Small net: yolo_mobilev1 alpha 0.5 at 64x64, grids 2x2 and 4x4, 4
classes, seeded by ``tests/torch_parity.py``.  A ``torch.export`` program
runs the same ops as the eager module, so the port's programs are held
to their eager forms exactly (after ``torch.export.save`` / ``load``);
against JAX's serving StableHLO, which letterboxes and sums in its own
order, detections are matched as sets.
"""

import builtins
import importlib.util

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from k210_yolo_framework_tpu import config as JConfig
from k210_yolo_framework_tpu.export import export_serving_stablehlo
from k210_yolo_framework_tpu.inference import Predictor as JaxPredictor
from k210_yolo_framework_tpu_torch import config as TConfig
from k210_yolo_framework_tpu_torch.export import (
    ServingProgram,
    export_raw,
    export_serving,
    freeze,
)
from k210_yolo_framework_tpu_torch.inference import Predictor
from k210_yolo_framework_tpu_torch.ops import nms as N
from k210_yolo_framework_tpu_torch.ops.nms import NmsResult
from k210_yolo_framework_tpu_torch.training import checkpoint as TC
from k210_yolo_framework_tpu_torch.utils.detmatch import (
    assert_detections_close,
)

from torch_parity import jax_weights, port_net

torch.set_num_threads(1)

ANCHORS = np.array([[[0.7, 0.6], [0.5, 0.5], [0.4, 0.3]],
                    [[0.3, 0.3], [0.2, 0.2], [0.15, 0.15]]], np.float32)
_SPEC_ARGS = ((64, 64), ((2, 2), (4, 4)), 4, ANCHORS)
JSPEC = JConfig.YoloSpec.create(*_SPEC_ARGS)
TSPEC = TConfig.YoloSpec.create(*_SPEC_ARGS)
KW = dict(obj_thresh=0.3, iou_thresh=0.45)


def _net_and_state():
    _, variables, flat = jax_weights("yolo_mobilev1", (64, 64), 3, 4,
                                     alpha=0.5)
    return (port_net("yolo_mobilev1", (64, 64), 3, 4, 0.5),
            TC.state_dict_from_flat(flat), variables)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    canvases = rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    hws = np.array([[64, 64], [32, 64]], np.int32)
    return torch.from_numpy(canvases), torch.from_numpy(hws)


def _assert_same(got, want):
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def _roundtrip(ep, tmp_path, name):
    path = tmp_path / name
    torch.export.save(ep, path)
    return torch.export.load(path)


def test_raw_program_equals_eager_forward(tmp_path):
    net, state, _ = _net_and_state()
    ep = _roundtrip(export_raw(net, state, batch=2, device="cpu"), tmp_path, "raw.pt2")
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32))
    got = ep.module()(x)
    net.load_state_dict(state)
    with torch.no_grad():
        want = net.forward_raw(x)
    assert [tuple(t.shape) for t in got] == [(2, 2, 2, 27), (2, 4, 4, 27)]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_serving_program_survives_save_and_load(tmp_path):
    net, state, _ = _net_and_state()
    pred = Predictor(net, state, TSPEC, device="cpu", **KW)
    ep = _roundtrip(export_serving(pred, batch=2), tmp_path, "s.pt2")
    canvases, hws = _inputs()
    got = ep.module()(canvases, hws)
    want = ServingProgram(pred)(canvases, hws)
    _assert_same(got, want)
    assert int(got[3].sum()) > 20
    # the program is the eager plain path: letterbox, /max, net, decode,
    # batched_nms over the full candidate set
    assert ServingProgram(pred).top_k == (4 + 16) * 3


def test_serving_program_matches_jax_export():
    """The port's program against JAX's exported serving StableHLO, on
    the same weights and canvases, as detection sets."""
    from jax import export as jexport

    net, state, variables = _net_and_state()
    jnet = jax_weights("yolo_mobilev1", (64, 64), 3, 4, alpha=0.5)[0]
    jp = JaxPredictor(jnet, dict(variables), JSPEC, compute_dtype=jnp.float32,
                      **KW)
    restored = jexport.deserialize(bytearray(
        export_serving_stablehlo(jp, batch=2)))
    canvases, hws = _inputs()
    want = restored.call(jnp.asarray(canvases.numpy()),
                         jnp.asarray(hws.numpy()))
    pred = Predictor(net, state, TSPEC, device="cpu", **KW)
    got = ServingProgram(pred)(canvases, hws)
    n_a, _ = assert_detections_close(
        NmsResult(*(t.numpy() for t in got)),
        NmsResult(*(np.asarray(t) for t in want)))
    assert n_a > 20


@pytest.mark.parametrize("mode", ["int8", "int8_act_cal"])
def test_quantized_serving_program(tmp_path, mode):
    """int8: the program holds the kernels as int8 buffers and their fp32
    scales (a file well under the fp32 program's) and dequantizes inside;
    int8_act_cal: the calibrated ranges go into the program.  Each equals
    its eager program after save and load."""
    net, state, _ = _net_and_state()
    canvases, hws = _inputs()
    pred = Predictor(net, state, TSPEC, device="cpu", quantize=mode, **KW)
    if mode == "int8_act_cal":
        with pytest.raises(RuntimeError, match="calibrate"):
            export_serving(pred, batch=2)
        pred.calibrate(*(t.numpy() for t in _inputs(seed=3)))
    path = tmp_path / "q.pt2"
    torch.export.save(export_serving(pred, batch=2), path)
    ep = torch.export.load(path)
    _assert_same(ep.module()(canvases, hws), ServingProgram(pred)(canvases,
                                                                   hws))
    int8 = [v for v in ep.state_dict.values() if v.dtype == torch.int8]
    if mode == "int8":
        assert len(int8) == len(pred.qweights) > 0
        fp = Predictor(net, state, TSPEC, device="cpu", **KW)
        torch.export.save(export_serving(fp, batch=2), tmp_path / "f.pt2")
        assert path.stat().st_size < 0.6 * (tmp_path / "f.pt2").stat().st_size
    else:
        assert not int8


@pytest.mark.parametrize("seed", [0, 1])
def test_traced_greedy_equals_greedy_keep_sorted(seed):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 100, (3, 4, 40, 2)).astype(np.float32)
    wh = rng.uniform(5, 40, (3, 4, 40, 2)).astype(np.float32)
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1))
    boxes[0, 0, 5] = boxes[0, 0, 4]                 # a duplicate box
    valid = torch.from_numpy(rng.uniform(size=(3, 4, 40)) > 0.2)
    for iou in (0.3, 0.6):
        want = N.greedy_keep_sorted(boxes, valid, iou)
        got = N.greedy_keep_sorted_traced(boxes, valid, iou)
        assert torch.equal(got, want)
    assert want.sum() < valid.sum()            # something was suppressed


def test_freeze_writes_the_artifacts(tmp_path, capsys):
    net, state, _ = _net_and_state()
    arts = freeze(net, state, TSPEC, str(tmp_path / "out"), batch=1,
                  tflite_int8=True, model_def="yolo_mobilev1", device="cpu")
    out = capsys.readouterr().out
    names = {k: v.rsplit("/", 1)[1] for k, v in arts.items()}
    assert names == {"program": "yolo_model.pt2",
                     "serving": "yolo_serving.pt2",
                     "npz": "yolo_model.npz", "h5": "yolo_model.h5",
                     "reference_h5": "yolo_model_reference.h5"}
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == sorted(
        names.values())
    assert "Model Inputs Node:  image:0 (1, 64, 64, 3) float32" in out
    assert "Model Outputs Node: l1/raw:0 (1, 2, 2, 27) float32" in out
    assert "Model Outputs Node: l2/raw:0 (1, 4, 4, 27) float32" in out
    assert out.count("skipping the") == 2      # .tflite and int8 .tflite
    for loader in (TC.load_npz, TC.load_h5):
        path = arts["npz"] if loader is TC.load_npz else arts["h5"]
        back = loader(path, net)
        assert all(torch.equal(back[k], v) for k, v in state.items())
    back = TC.load_variables(arts["reference_h5"], "yolo_mobilev1", net)
    assert all(torch.equal(back[k], v) for k, v in state.items())
    serving = torch.export.load(arts["serving"]).module()
    canvases, hws = _inputs()
    _assert_same(serving(canvases[:1], hws[:1]), ServingProgram(
        Predictor(net, state, TSPEC, device="cpu"))(canvases[:1], hws[:1]))


def test_freeze_without_h5py(tmp_path, capsys, monkeypatch):
    """Where h5py does not import (the H100 machine) the h5 files are not
    written and a NOTE says so."""
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: (
        None if name == "h5py" else real(name, *a)))
    real_import = builtins.__import__

    def no_h5py(name, *args, **kwargs):
        if name == "h5py":
            raise ImportError("no h5py")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    net, state, _ = _net_and_state()
    arts = freeze(net, state, TSPEC, str(tmp_path), tflite=False,
                  model_def="yolo_mobilev1", device="cpu")
    out = capsys.readouterr().out
    assert sorted(arts) == ["npz", "program", "serving"]
    assert "h5py unavailable" in out and "skipping the" not in out


def test_export_leaves_the_constant_caches_real():
    """Fault s: the letterbox's and the decode's constant caches
    (``ops/letterbox._const``, ``ops/codec._grid_consts``) once kept the
    tensors ``torch.export`` traced with, and eager serving after an
    export then read them.  Serving after an export equals serving
    before it."""
    from k210_yolo_framework_tpu_torch.ops import codec, letterbox

    net, state, _ = _net_and_state()
    pred = Predictor(net, state, TSPEC, device="cpu", **KW)
    canvases, hws = (t.numpy() for t in _inputs(seed=4))
    letterbox._cached_const.cache_clear()
    codec._grid_consts_on.cache_clear()
    before = pred.predict_batch(canvases, hws)
    export_serving(pred, batch=2)
    after = pred.predict_batch(canvases, hws)
    for a, b in zip(after, before):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert sum(len(d.scores) for d in after) > 0
    # the keys the export used: real tensors, not the tracer's
    for t in (letterbox._const((64.0, 64.0), torch.device("cpu")),
              *codec._grid_consts(1, TSPEC, torch.zeros(1))):
        assert type(t) is torch.Tensor

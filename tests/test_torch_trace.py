"""The port's spans (``utils/trace.span``): their names and nesting under
``torch.profiler`` in the serving entry, the fused train step and ``fit``'s
exported trace; nothing entered with no profiler; no profiler op in an
exported program; the same numbers, bit for bit, with and without a
profiler.

Small net: yolo_mobilev1 alpha 0.5 at 64x64, grids 2x2 and 4x4, 4
classes, on the CPU.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from k210_yolo_framework_tpu_torch import config as TConfig
from k210_yolo_framework_tpu_torch.data import pipeline as TPL
from k210_yolo_framework_tpu_torch.export import export_raw, export_serving
from k210_yolo_framework_tpu_torch.inference import Predictor
from k210_yolo_framework_tpu_torch.models import build_network
from k210_yolo_framework_tpu_torch.ops.codec import MAX_BOXES
from k210_yolo_framework_tpu_torch.training import train as TT
from k210_yolo_framework_tpu_torch.utils import trace as TR

torch.set_num_threads(1)

ANCHORS = np.array([[[0.7, 0.6], [0.5, 0.5], [0.4, 0.3]],
                    [[0.3, 0.3], [0.2, 0.2], [0.15, 0.15]]], np.float32)
SPEC = TConfig.YoloSpec.create((64, 64), ((2, 2), (4, 4)), 4, ANCHORS)
CFG = TConfig.TrainConfig(batch_size=4, init_learning_rate=1e-3)

SERVE_STAGES = ["serve.h2d", "serve.letterbox", "serve.net", "serve.head",
                "serve.d2h", "serve.detections"]
TRAIN_STAGES = ["train.preprocess", "train.forward", "train.loss",
                "train.backward", "train.optimizer", "train.metrics"]
PREPROCESS_STAGES = ["preprocess.letterbox", "preprocess.augment",
                     "preprocess.normalize", "preprocess.encode"]


def _net():
    return build_network("yolo_mobilev1", SPEC.in_hw, SPEC.nanchors,
                         SPEC.class_num, alpha=0.5,
                         generator=torch.Generator().manual_seed(3))


def _predictor():
    return Predictor(_net(), None, SPEC, obj_thresh=0.05, device="cpu")


def _canvases(seed=0, b=2):
    rng = np.random.default_rng(seed)
    canvases = rng.integers(0, 256, (b, 96, 96, 3)).astype(np.uint8)
    hws = np.array([[96, 96], [48, 80]] * (b // 2), np.int32)
    return canvases, hws


def _host_batch(seed=0, b=4):
    canvases, hws = _canvases(seed, b)
    rng = np.random.default_rng(seed + 100)
    boxes = np.zeros((b, MAX_BOXES, 5), np.float32)
    valid = np.zeros((b, MAX_BOXES), bool)
    boxes[:, :3, 0] = rng.integers(0, SPEC.class_num, (b, 3))
    boxes[:, :3, 1:3] = rng.uniform(0.3, 0.7, (b, 3, 2))
    boxes[:, :3, 3:] = rng.uniform(0.1, 0.4, (b, 3, 2))
    valid[:, :3] = True
    return TPL.HostBatch(canvases, hws, boxes, valid)


def _fused_step():
    return TT.make_fused_train_step(SPEC, CFG,
                                    TPL.make_preprocess_fn(SPEC, True))


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted((e.time_range.start, e.time_range.end, e.thread,
                    e.name[len(TR.PREFIX):]) for e in prof.events()
                   if e.name.startswith(TR.PREFIX))
    return out, spans


def _named(spans, name):
    return [s for s in spans if s[3] == name]


def _inside(inner, outer):
    return (outer[0] <= inner[0] and inner[1] <= outer[1]
            and inner[2] == outer[2])


@pytest.mark.parametrize("entry", ["predict_batch", "predict_image"])
def test_serving_entry_emits_each_stage_once_inside_its_call(entry):
    pred = _predictor()
    canvases, hws = _canvases()
    if entry == "predict_batch":
        call = lambda: pred.predict_batch(canvases, hws)  # noqa: E731
    else:
        call = lambda: pred.predict_image(  # noqa: E731
            canvases[1, :hws[1, 0], :hws[1, 1]])
    _, spans = _profiled(call)
    (outer,) = _named(spans, "serve.batch")
    assert sorted(s[3] for s in spans) == sorted(["serve.batch"]
                                                 + SERVE_STAGES)
    stages = [s for s in spans if s[3] != "serve.batch"]
    assert [s[3] for s in stages] == SERVE_STAGES    # in this order
    for s in stages:
        assert _inside(s, outer), s[3]
    for a, b in zip(stages, stages[1:]):             # none overlaps
        assert a[1] <= b[0], (a[3], b[3])


def test_fused_train_step_emits_its_stages_nested():
    state = TT.create_train_state(_net(), CFG, "cpu")
    hb = _host_batch().to("cpu")
    step = _fused_step()
    _, spans = _profiled(lambda: step(state, *hb, torch.Generator()
                                      .manual_seed(1)))
    (outer,) = _named(spans, "train.step")
    names = [s[3] for s in spans]
    assert sorted(names) == sorted(["train.step"] + TRAIN_STAGES
                                   + PREPROCESS_STAGES)
    assert "train.grad_allreduce" not in names        # no mesh
    stages = [s for s in spans if s[3] in TRAIN_STAGES]
    assert [s[3] for s in stages] == TRAIN_STAGES
    for s in stages:
        assert _inside(s, outer), s[3]
    (pre,) = _named(spans, "train.preprocess")
    inner = [s for s in spans if s[3] in PREPROCESS_STAGES]
    assert [s[3] for s in inner] == PREPROCESS_STAGES
    for s in inner:
        assert _inside(s, pre), s[3]


def test_fit_profile_trace_holds_the_train_and_fit_spans(tmp_path):
    batches = iter([_host_batch(i) for i in range(3)])
    TT.fit(_net(), SPEC, dataclasses.replace(CFG, max_epochs=1), batches,
           None,
           TPL.make_preprocess_fn(SPEC, True), None, 3, 0, device="cpu",
           log_fn=lambda _line: None, profile_dir=str(tmp_path),
           profile_step=2)
    trace = json.loads((tmp_path / "trace_step2.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    want = {TR.PREFIX + n for n in ["train.step", "fit.load"]
            + TRAIN_STAGES + PREPROCESS_STAGES}
    assert want <= names, sorted(want - names)


def test_no_profiler_no_record_function(monkeypatch):
    """With no profiler recording, ``span`` hands back one shared no-op and
    never enters ``record_function``: not in the serving entry, not in the
    train step."""
    def refuse(*_args, **_kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert TR.span("serve.net") is TR.span("train.step")
    pred = _predictor()
    pred.predict_batch(*_canvases())
    pred.predict_image(_canvases()[0][0])
    state = TT.create_train_state(_net(), CFG, "cpu")
    _fused_step()(state, *_host_batch().to("cpu"),
                  torch.Generator().manual_seed(1))


def _has_profiler_op(program) -> bool:
    return any("profiler" in str(node.target)
               for node in program.graph_module.graph.nodes)


@pytest.mark.parametrize("which", ["serving", "raw"])
def test_export_under_a_profiler_holds_no_profiler_op(which):
    pred = _predictor()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        if which == "serving":
            program = export_serving(pred, batch=2, canvas_hw=(96, 96))
        else:
            program = export_raw(_net(), None, batch=2, device="cpu")
    assert not _has_profiler_op(program)
    if which == "serving":      # the program still serves what it did
        canvases, hws = _canvases()
        got = program.module()(torch.from_numpy(canvases),
                               torch.from_numpy(hws))
        assert len(got) == 4


def _serve_outputs(profiled: bool):
    pred = _predictor()
    canvases, hws = _canvases(seed=5, b=4)

    def call():
        return (pred.predict_batch(canvases, hws),
                pred.predict_image(canvases[1, :hws[1, 0], :hws[1, 1]]))

    out = _profiled(call)[0] if profiled else call()
    batch, single = out
    return [a for d in batch + [single] for a in d]


def _train_outputs(profiled: bool):
    state = TT.create_train_state(_net(), CFG, "cpu")
    step = _fused_step()
    gen = torch.Generator().manual_seed(7)
    losses = []

    def two_steps():
        nonlocal state
        for i in range(2):
            state, logs = step(state, *_host_batch(i).to("cpu"), gen)
            losses.append(logs["loss"].detach().clone())

    if profiled:
        _profiled(two_steps)
    else:
        two_steps()
    return losses + [v.detach().clone()
                     for v in state.net.state_dict().values()]


@pytest.mark.parametrize("outputs", [_serve_outputs, _train_outputs],
                         ids=["serve", "train"])
def test_the_same_numbers_with_and_without_a_profiler(outputs):
    plain, traced = outputs(False), outputs(True)
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        a, b = torch.as_tensor(np.asarray(a)), torch.as_tensor(np.asarray(b))
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)

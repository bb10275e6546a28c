"""The port's command-line entry points (``k210_yolo_framework_tpu_torch/
cli``) on the CPU (``--device cpu``), on a small synthetic set in a
temporary directory laid out as the scripts expect (``data/<set>_...``),
held to the JAX package's root scripts on the same inputs.

Sizes: yolo_mobilev1 alpha 0.5 at 96x96 (grids 3x3 and 6x6), 4 classes,
batch 4.  The JAX ``Predictor`` letterboxes under jit, which departs from
its eager letterbox where ``img * scale`` is inexact in fp32 (fault q in
ROADMAP.md); the images served by both packages here have exact scales
(1/2, 1, 2).  Tables printed by the two inference scripts are compared as
detection sets (``utils/detmatch.py``) at their print precision: boxes to
0.1 pixel, scores to 0.01.
"""

import json
import os
import re
import signal
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from k210_yolo_framework_tpu.training import checkpoint as JCK
from k210_yolo_framework_tpu.utils import tboard as JTB
from k210_yolo_framework_tpu_torch import config as TConfig
from k210_yolo_framework_tpu_torch.cli import keras_eval as TKE
from k210_yolo_framework_tpu_torch.cli import keras_inference as TKI
from k210_yolo_framework_tpu_torch.cli import keras_train as TKT
from k210_yolo_framework_tpu_torch.cli import make_anchor_list as TMA
from k210_yolo_framework_tpu_torch.cli import make_voc_list as TMV
from k210_yolo_framework_tpu_torch.data import pipeline as TPL
from k210_yolo_framework_tpu_torch.inference import (
    Detections,
    stack_detections,
)
from k210_yolo_framework_tpu_torch.models import build_network
from k210_yolo_framework_tpu_torch.training import checkpoint as TC
from k210_yolo_framework_tpu_torch.training import train as TT
from k210_yolo_framework_tpu_torch.utils.detmatch import (
    assert_detections_close,
)

from torch_parity import jax_weights

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))   # the JAX package's root scripts

import keras_eval as JKE          # noqa: E402
import keras_inference as JKI     # noqa: E402
import make_anchor_list as JMA    # noqa: E402
import make_voc_list as JMV       # noqa: E402

torch.set_num_threads(1)

ANCHORS = np.array([[[0.7, 0.6], [0.5, 0.5], [0.4, 0.3]],
                    [[0.3, 0.3], [0.2, 0.2], [0.15, 0.15]]], np.float32)
NET = ["--train_set", "s", "--class_num", "4", "--model_def",
       "yolo_mobilev1", "--depth_multiplier", "0.5", "--image_size", "96",
       "96", "--output_size", "3", "3", "6", "6"]
TRAIN = NET + ["--device", "cpu", "--batch_size", "4",
               "--vaildation_split", "0.34", "--compute_dtype", "float32"]
# (h, w) whose letterbox scale into 96x96 is exact in fp32
EXACT_HW = [(192, 144), (96, 96), (192, 192), (48, 40), (384, 300),
            (96, 72), (192, 120), (48, 48)]


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """A working directory holding data/s_img_ann.npy (12 JPEGs, 4
    classes) and data/s_anchor.npy."""
    root = tmp_path_factory.mktemp("cli")
    (root / "data" / "imgs").mkdir(parents=True)
    ann = TPL.synthetic_ann_list(str(root / "data" / "imgs"), n=12,
                                 class_num=4, seed=2)
    np.save(root / "data" / "s_img_ann.npy", ann)
    np.save(root / "data" / "s_anchor.npy", ANCHORS)
    return root


@pytest.fixture(scope="module")
def exact(tmp_path_factory):
    """A working directory whose set 's' holds 8 JPEGs of EXACT_HW, and a
    JAX-written native .h5 of drawn weights for the CLI net."""
    from PIL import Image

    root = tmp_path_factory.mktemp("exact")
    (root / "data").mkdir()
    rng = np.random.default_rng(9)
    rows = []
    for i, (h, w) in enumerate(EXACT_HW):
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        path = str(root / "data" / f"img_{i}.png")
        Image.fromarray(img).save(path)
        nb = int(rng.integers(1, 4))
        boxes = np.hstack([rng.integers(0, 4, (nb, 1)).astype(float),
                           rng.uniform(0.3, 0.7, (nb, 2)),
                           rng.uniform(0.1, 0.4, (nb, 2))])
        rows.append(np.array([path, boxes, np.array([h, w])], dtype=object))
    np.save(root / "data" / "s_img_ann.npy", np.array(rows, dtype=object))
    np.save(root / "data" / "s_anchor.npy", ANCHORS)
    _, variables, _ = jax_weights("yolo_mobilev1", (96, 96), 3, 4, alpha=0.5)
    JCK.save_h5(str(root / "w.h5"), variables)
    return root


def _train(args, monkeypatch, where):
    monkeypatch.chdir(where)
    return TKT.main(TKT.parse_args(TRAIN + args))


# ---- keras_train --------------------------------------------------------

def test_keras_train_writes_every_run_output(synth, monkeypatch, capsys):
    run = _train(["--max_nrof_epochs", "2", "--log_dir", "log_all",
                  "--profile", "True", "--bn_recalibrate", "1"],
                 monkeypatch, synth)
    out = capsys.readouterr().out
    assert run.parent == Path("log_all") and (synth / run).is_dir()
    args = (run / "args.txt").read_text().splitlines()
    assert "device: cpu" in args and "train_set: s" in args
    lines = [json.loads(l) for l in
             (run / "scalars.jsonl").read_text().splitlines()]
    assert [d["step"] for d in lines] == [1, 2, 3, 4]
    assert {"loss", "p", "r", "lr", "l1_loss", "l2_r"} <= set(lines[0])
    assert "sparsity" not in lines[0]
    events = list(run.glob("events.out.tfevents.*"))
    assert len(events) == 1
    ev = list(JTB.read_events(str(events[0])))[1:]
    assert [e["step"] for e in ev] == [1, 2, 3, 4]
    for e, d in zip(ev, lines):
        np.testing.assert_allclose(e["scalars"]["loss"], d["loss"],
                                   rtol=1e-7)
    traces = list((run / "profile").glob("*.json"))
    assert len(traces) == 1 and "traceEvents" in traces[0].read_text()
    assert "profiler trace written to" in out
    assert "recalibrating BN statistics over 1 batches" in out
    assert (run / "ckpt" / TC.STATE_FILE).is_file()
    net = build_network("yolo_mobilev1", (96, 96), 3, 4, alpha=0.5)
    npz = TC.load_variables(str(run / "yolo_model.npz"), "yolo_mobilev1",
                            net)
    h5 = TC.load_variables(str(run / "yolo_model.h5"), "yolo_mobilev1", net)
    for k in npz:
        assert torch.equal(npz[k], h5[k]), k
    assert f"Save Model as {run / 'yolo_model.npz'} and " in out
    # the JAX package reads the .h5 the run wrote
    _, variables, _ = jax_weights("yolo_mobilev1", (96, 96), 3, 4, alpha=0.5)
    loaded = JCK.load_h5(str(run / "yolo_model.h5"),
                         {"params": variables["params"],
                          "batch_stats": variables["batch_stats"]})
    flat = TC.flat_from_state_dict(npz)
    np.testing.assert_array_equal(
        np.asarray(loaded["params"]["backbone"]["stem"]["conv"]["kernel"]),
        flat["params/backbone/stem/conv/kernel"])


def test_keras_train_pruned_reaches_the_target_sparsity(synth, monkeypatch):
    """2 steps an epoch, prune_end_epoch 1: the masks' last update falls
    on the schedule's end step (2) at the final sparsity."""
    run = _train(["--max_nrof_epochs", "2", "--log_dir", "log_prune",
                  "--is_prune", "True", "--prune_frequency", "1",
                  "--prune_end_epoch", "1"], monkeypatch, synth)
    assert not (run / "yolo_model.npz").exists()
    lines = [json.loads(l) for l in
             (run / "scalars.jsonl").read_text().splitlines()]
    assert [round(d["sparsity"], 3) for d in lines] == [0.5, 0.85, 0.9, 0.9]
    n_checked = 0
    with np.load(run / "yolo_prune_model.npz") as z:
        for k in z.files:
            if k.endswith("/kernel") and z[k].size >= 1000:
                zero = float((z[k] == 0).mean())
                assert abs(zero - 0.9) <= 1.0 / z[k].size + 1e-3, (k, zero)
                n_checked += 1
    assert n_checked >= 25


def test_keras_train_resumes_from_its_ckpt(synth, monkeypatch, capsys):
    first = _train(["--max_nrof_epochs", "1", "--log_dir", "log_r1",
                    "--is_prune", "True", "--prune_frequency", "1"],
                   monkeypatch, synth)
    second = _train(["--max_nrof_epochs", "1", "--log_dir", "log_r2",
                     "--is_prune", "True", "--prune_frequency", "1",
                     "--pre_ckpt", str(first / "ckpt")], monkeypatch, synth)
    assert f"Load CKPT {first / 'ckpt'} (step 2)" in capsys.readouterr().out
    lines = [json.loads(l) for l in
             (second / "scalars.jsonl").read_text().splitlines()]
    assert [d["step"] for d in lines] == [3, 4]
    state = TT.create_train_state(
        build_network("yolo_mobilev1", (96, 96), 3, 4, alpha=0.5),
        TConfig.TrainConfig(is_prune=True), "cpu")
    assert TC.restore_state(str(second / "ckpt"), state).step == 4
    # weights alone: a fresh step count
    third = _train(["--max_nrof_epochs", "1", "--log_dir", "log_r3",
                    "--pre_ckpt", str(second / "yolo_prune_model.npz")],
                   monkeypatch, synth)
    lines = [json.loads(l) for l in
             (third / "scalars.jsonl").read_text().splitlines()]
    assert [d["step"] for d in lines] == [1, 2]


def test_keras_train_sigterm_still_saves(synth, monkeypatch, capsys):
    """SIGTERM during the third train step of a run that would not end:
    the step finishes, the run is saved whole and loads, and the signal
    handlers are restored."""
    make = TPL.make_preprocess_fn
    calls = {"n": 0}

    def preprocess_fn(spec, is_training, dtype=None):
        pp = make(spec, is_training, dtype)

        def wrapped(*args, **kw):
            if is_training:
                calls["n"] += 1
                if calls["n"] == 3:
                    os.kill(os.getpid(), signal.SIGTERM)
            return pp(*args, **kw)
        return wrapped

    monkeypatch.setattr(TPL, "make_preprocess_fn", preprocess_fn)
    before = signal.getsignal(signal.SIGTERM)
    run = _train(["--max_nrof_epochs", "100000", "--log_dir", "log_term"],
                 monkeypatch, synth)
    assert "interrupted" in capsys.readouterr().out
    assert signal.getsignal(signal.SIGTERM) == before
    state = TT.create_train_state(
        build_network("yolo_mobilev1", (96, 96), 3, 4, alpha=0.5),
        TConfig.TrainConfig(), "cpu")
    assert TC.restore_state(str(run / "ckpt"), state).step == 3
    sd = TC.load_variables(str(run / "yolo_model.npz"), "yolo_mobilev1",
                           state.net)
    assert all(torch.isfinite(v).all() for v in sd.values())
    for k, v in state.net.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_keras_train_guards(synth, monkeypatch):
    monkeypatch.chdir(synth)
    with pytest.raises(SystemExit) as e:
        TKT.main(TKT.parse_args(NET + [
            "--device", "cpu", "--batch_size", "16", "--log_dir", "log_g"]))
    # keras_train.py's text, for the 11 train rows of 12 at split 0.1
    assert str(e.value) == (
        "train set has 11 images < batch_size 16: zero steps per epoch "
        "(drop_remainder batching, utils.py:449-450) — lower --batch_size")
    assert "zero steps per epoch (drop_remainder" in \
        (REPO / "keras_train.py").read_text()
    # --mesh as keras_train.py parses it: a model axis is not ported yet,
    # more than three axes exit with the JAX script's text, and the batch
    # must divide by dp
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 3"):
        TKT.main(TKT.parse_args(TRAIN + ["--mesh", "1,2"]))
    with pytest.raises(SystemExit) as e:
        TKT.main(TKT.parse_args(TRAIN + ["--mesh", "2,2,1,1"]))
    assert str(e.value) == ("--mesh '2,2,1,1': format is 'dp,mp[,sp]' or "
                            "'auto' (at most 3 axes)")
    assert "format is 'dp,mp[,sp]' " in (REPO / "keras_train.py").read_text()
    with pytest.raises(SystemExit, match="does not divide"):
        TKT.main(TKT.parse_args(TRAIN + ["--mesh", "3"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TKT.main(TKT.parse_args(NET + ["--log_dir", "log_g"]))


def test_keras_train_on_a_two_rank_mesh(synth, monkeypatch, capsys):
    """--mesh 2 --device cpu: two gloo ranks train the global batch of 8
    for 2 steps; rank 0 alone writes the run, one checkpoint of it."""
    run = _train(["--mesh", "2", "--batch_size", "8", "--max_nrof_epochs",
                  "2", "--log_dir", "log_mesh"], monkeypatch, synth)
    assert [p.name for p in (synth / "log_mesh").iterdir()] == [run.name]
    lines = [json.loads(l) for l in
             (run / "scalars.jsonl").read_text().splitlines()]
    assert [d["step"] for d in lines] == [1, 2]
    assert len(list(run.glob("events.out.tfevents.*"))) == 1
    state = TT.create_train_state(
        build_network("yolo_mobilev1", (96, 96), 3, 4, alpha=0.5),
        TConfig.TrainConfig(), "cpu")
    assert TC.restore_state(str(run / "ckpt"), state).step == 2
    assert list((run / "ckpt").iterdir()) == [run / "ckpt" / TC.STATE_FILE]
    sd = TC.load_variables(str(run / "yolo_model.npz"), "yolo_mobilev1",
                           state.net)
    for k, v in state.net.state_dict().items():
        assert torch.equal(sd[k], v), k
    # every rank resumes the checkpoint (Adam moments included): the step
    # count goes on
    again = _train(["--mesh", "2", "--batch_size", "8", "--max_nrof_epochs",
                    "1", "--log_dir", "log_mesh2", "--pre_ckpt",
                    str(run / "ckpt")], monkeypatch, synth)
    lines = [json.loads(l) for l in
             (again / "scalars.jsonl").read_text().splitlines()]
    assert [d["step"] for d in lines] == [3]
    assert TC.restore_state(str(again / "ckpt"), state).step == 3


# ---- keras_inference / keras_eval -------------------------------------

_ROW = re.compile(r"^\[(\S+)\t(\S+)\t(\S+)\t(\S+)\t(\S+)\t\s*(\d+)\]$")


def _table(out: str) -> Detections:
    rows = [m.groups() for m in map(_ROW.match, out.splitlines()) if m]
    a = np.array(rows, dtype=np.float64).reshape(-1, 6)
    return Detections(a[:, :4], a[:, 4], a[:, 5].astype(int))


@pytest.mark.parametrize("image", [0, 3])
def test_keras_inference_prints_the_jax_table(exact, monkeypatch, capsys,
                                              image):
    monkeypatch.chdir(exact)
    img = str(exact / "data" / f"img_{image}.png")
    flags = NET + ["--obj_thresh", "0.3", str(exact / "w.h5"), img]
    JKI.main(JKI.parse_args(flags + ["--output", str(exact / "j.png")]))
    want = _table(capsys.readouterr().out)
    det = TKI.main(TKI.parse_args(flags + ["--device", "cpu", "--output",
                                           str(exact / "t.png")]))
    out = capsys.readouterr().out
    got = _table(out)
    assert len(got.scores) == len(det.scores) > 0
    assert "[top\tleft\tbottom\tright\tscore\tclass]" in out
    # print precision: a score rounded on each side may differ by 0.01
    assert_detections_close(stack_detections([got]),
                            stack_detections([want]), score_tol=0.0101)
    assert (exact / "t.png").is_file()
    from PIL import Image
    assert Image.open(exact / "t.png").size == Image.open(img).size


def _aps(out: str):
    aps = dict(re.findall(r"^\s+(\S+)\s+AP@0\.50 = (\S+)$", out, re.M))
    m = re.search(r"mAP@0\.50 = (\S+)", out)
    return {k: float(v) for k, v in aps.items()}, float(m.group(1))


def test_keras_eval_map_matches_jax(exact, monkeypatch, capsys):
    monkeypatch.chdir(exact)
    flags = [str(exact / "w.h5")] + NET + ["--batch_size", "4"]
    assert JKE.main(JKE.parse_args(flags)) == 0
    want_ap, want_map = _aps(capsys.readouterr().out)
    res = TKE.main(TKE.parse_args(flags + ["--device", "cpu", "--coco"]))
    out = capsys.readouterr().out
    got_ap, got_map = _aps(out)
    assert "mAP@[.5:.95]" in out and "imgs/s over 8 images on cpu" in out
    assert abs(res["map"] - got_map) <= 5e-5
    # set-level: scores an ulp apart can reorder the PR curve
    assert sorted(got_ap) == sorted(want_ap)
    assert abs(got_map - want_map) <= 0.02, (got_map, want_map)


def _served(exact, quantize, **kw):
    """The Predictor the scripts build for the CLI net, from ``w.h5``."""
    from k210_yolo_framework_tpu_torch.inference import Predictor

    spec = TConfig.YoloSpec.from_files(str(exact / "data" / "s_anchor.npy"),
                                       in_hw=(96, 96), out_hws=((3, 3), (6, 6)),
                                       class_num=4)
    net = build_network("yolo_mobilev1", spec.in_hw, spec.nanchors, 4,
                        alpha=0.5)
    state = TC.load_variables(str(exact / "w.h5"), "yolo_mobilev1", net)
    return Predictor(net, state, spec, quantize=quantize, device="cpu", **kw)


@pytest.mark.parametrize("mode", ["int8", "int8_act", "int8_act_cal"])
def test_inference_and_eval_quantized(exact, monkeypatch, capsys, mode):
    """--quantize through both scripts: keras_inference's detections are
    predict_image's of the same Predictor (int8_act_cal calibrated on the
    image itself), keras_eval's mAP is evaluate_map's (int8_act_cal holding
    the last --calib_size rows out of the eval for calibration)."""
    from k210_yolo_framework_tpu_torch.data.annotations import (
        load_ann_list,
        read_image,
    )
    from k210_yolo_framework_tpu_torch.eval import (
        calibrate_from_rows,
        evaluate_map,
    )

    monkeypatch.chdir(exact)
    img = str(exact / "data" / "img_0.png")
    det = TKI.main(TKI.parse_args(NET + [
        "--device", "cpu", "--quantize", mode, "--obj_thresh", "0.3",
        "--output", str(exact / "q.png"), str(exact / "w.h5"), img]))
    pixels = read_image(img)
    pred = _served(exact, mode, obj_thresh=0.3)
    assert pred.quantize == mode
    if mode == "int8_act_cal":
        pred.calibrate(pixels[None], np.asarray([pixels.shape[:2]], np.int32))
    want = pred.predict_image(pixels)
    assert len(det.scores) > 0
    for a, b in zip(det, want):
        np.testing.assert_array_equal(a, b)
    assert len(_table(capsys.readouterr().out).scores) == len(det.scores)

    res = TKE.main(TKE.parse_args([str(exact / "w.h5")] + NET + [
        "--device", "cpu", "--batch_size", "4", "--quantize", mode,
        "--calib_size", "2"]))
    out = capsys.readouterr().out
    ann = load_ann_list("data/s_img_ann.npy")
    pred = _served(exact, mode, obj_thresh=0.01, iou_thresh=0.45,
                   max_out=100)
    if mode == "int8_act_cal":
        assert "calibrating on 2 rows" in out and "6 rows after" in out
        calibrate_from_rows(pred, ann[-2:])
        ann = ann[:-2]
    ref = evaluate_map(pred, ann, 4, batch_size=4)
    assert np.isfinite(res["map"]) and res["map"] == ref["map"]


def test_eval_calib_list(exact, synth, monkeypatch, capsys):
    """--calib_list: calibration on its first --calib_size rows, the eval
    set whole; a list sharing an image with the eval set raises."""
    from k210_yolo_framework_tpu_torch.data.annotations import load_ann_list
    from k210_yolo_framework_tpu_torch.eval import (
        calibrate_from_rows,
        evaluate_map,
    )

    monkeypatch.chdir(exact)
    calib = str(synth / "data" / "s_img_ann.npy")
    res = TKE.main(TKE.parse_args([str(exact / "w.h5")] + NET + [
        "--device", "cpu", "--batch_size", "4", "--quantize", "int8_act_cal",
        "--calib_list", calib, "--calib_size", "3"]))
    out = capsys.readouterr().out
    assert f"calibrating on 3 rows from {calib}" in out
    assert "evaluating 8 rows" in out
    pred = _served(exact, "int8_act_cal", obj_thresh=0.01, iou_thresh=0.45,
                   max_out=100)
    calibrate_from_rows(pred, load_ann_list(calib)[:3])
    ref = evaluate_map(pred, load_ann_list("data/s_img_ann.npy"), 4,
                       batch_size=4)
    assert res["map"] == ref["map"]
    with pytest.raises(ValueError, match="also appear in the eval"):
        TKE.main(TKE.parse_args([str(exact / "w.h5")] + NET + [
            "--device", "cpu", "--quantize", "int8_act_cal", "--calib_list",
            "data/s_img_ann.npy", "--calib_size", "2"]))
    with pytest.raises(ValueError, match="unknown --quantize"):
        TKE.main(TKE.parse_args([str(exact / "w.h5")] + NET + [
            "--device", "cpu", "--quantize", "int8act"]))


def test_keras_freeze_writes_the_artifacts(exact, monkeypatch, capsys):
    """keras_freeze on the JAX-written weights: the artifacts, the node
    lines of the JAX script, and a serving program equal to the eager one
    of the Predictor it wraps."""
    from k210_yolo_framework_tpu_torch.cli import keras_freeze as TKF
    from k210_yolo_framework_tpu_torch.export import ServingProgram

    monkeypatch.chdir(exact)
    arts = TKF.main(TKF.parse_args([str(exact / "w.h5")] + NET + [
        "--device", "cpu", "--out_dir", str(exact / "frz")]))
    out = capsys.readouterr().out
    assert sorted(arts) == ["h5", "npz", "program", "reference_h5",
                            "serving"]
    assert all(Path(v).is_file() for v in arts.values())
    assert "Model Inputs Node:  image:0 (1, 96, 96, 3) float32" in out
    assert "Model Outputs Node: l1/raw:0 (1, 3, 3, 27) float32" in out
    assert "Model Outputs Node: l2/raw:0 (1, 6, 6, 27) float32" in out
    assert "skipping the .tflite artifact" in out
    pred = _served(exact, None)
    rng = np.random.default_rng(5)
    canvas = torch.from_numpy(rng.integers(0, 256, (1, 96, 96, 3)).astype(
        np.uint8))
    hw = torch.tensor([[96, 80]], dtype=torch.int32)
    got = torch.export.load(arts["serving"]).module()(canvas, hw)
    for a, b in zip(got, ServingProgram(pred)(canvas, hw)):
        assert torch.equal(a, b)
    sd = TC.load_npz(arts["npz"], pred.net)
    assert all(torch.equal(sd[k], v.cpu()) for k, v in
               pred.net.state_dict().items())


# ---- make_voc_list / make_anchor_list ---------------------------------

def test_make_voc_list_writes_what_jax_writes(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(3)
    (tmp_path / "VOC" / "JPEGImages").mkdir(parents=True)
    (tmp_path / "VOC" / "labels").mkdir()
    paths = []
    for i, (h, w) in enumerate([(120, 200), (333, 250), (64, 64)]):
        p = tmp_path / "VOC" / "JPEGImages" / f"{i:06d}.jpg"
        Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(
            np.uint8)).save(p)
        boxes = np.hstack([rng.integers(0, 20, (i + 1, 1)),
                           rng.uniform(0, 1, (i + 1, 4))])
        np.savetxt(str(p).replace("JPEGImages", "labels")[:-4] + ".txt",
                   boxes, fmt="%g")
        paths.append(str(p))
    (tmp_path / "train.txt").write_text("\n".join(paths) + "\n\n")
    got = TMV.main(str(tmp_path / "train.txt"), str(tmp_path / "p.npy"))
    JMV.main(str(tmp_path / "train.txt"), str(tmp_path / "j.npy"))
    want = np.load(tmp_path / "j.npy", allow_pickle=True)
    saved = np.load(tmp_path / "p.npy", allow_pickle=True)
    assert saved.shape == want.shape == got.shape == (3, 3)
    for a, b in zip(saved, want):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])
    assert list(saved[2][2]) == [64, 64]


@pytest.mark.parametrize("layers", [2, 3])
def test_make_anchor_list_writes_what_jax_writes(synth, monkeypatch, capsys,
                                                 layers):
    """Fixed (linspace) initial centroids, so both scripts are
    deterministic: the same anchors (rtol 1e-6) and a plot from each."""
    monkeypatch.chdir(synth)
    out_hw = ["3", "3", "6", "6", "12", "12"][:2 * layers]
    flags = ["s", "--in_hw", "96", "96", "--out_hw", *out_hw,
             "--is_random", "False"]
    assert JMA.main(JMA.parse_arguments(flags)) == 0
    want = np.load("data/s_anchor.npy")
    os.replace("data/s_anchor.png", "data/j_anchor.png")
    assert TMA.main(TMA.parse_args(flags)) == 0
    got = np.load("data/s_anchor.npy")
    np.save("data/s_anchor.npy", ANCHORS)        # the fixture's anchors
    assert got.shape == want.shape == (layers, 3, 2)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert os.path.getsize("data/s_anchor.png") > 0
    assert "Now anchors are" in capsys.readouterr().out


def test_make_anchor_list_nan_asks_for_a_rerun(tmp_path, monkeypatch,
                                               capsys):
    """A NaN box makes every run NaN: both scripts exit 1, write nothing
    and ask for a rerun."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "data").mkdir()
    rows = [np.array(["x.jpg", np.array([[0, 0.5, 0.5, np.nan, 0.2],
                                         [1, 0.5, 0.5, 0.3, 0.2]]),
                      np.array([100, 120])], dtype=object)]
    np.save("data/n_img_ann.npy", np.array(rows, dtype=object))
    flags = ["n", "--is_plot", "False", "--in_hw", "96", "96"]
    assert JMA.main(JMA.parse_arguments(flags)) == 1
    assert TMA.main(TMA.parse_args(flags)) == 1
    assert capsys.readouterr().out.count("please Rerun") == 2
    assert not (tmp_path / "data" / "n_anchor.npy").exists()


@pytest.mark.parametrize("seed,layers,iters", [(0, 2, 10), (1, 3, 10),
                                               (7, 2, 30), (None, 2, 1)])
def test_generate_anchors_matches_jax(seed, layers, iters):
    """Random initial centroids drawn from the same numpy seed (a fresh
    entropy seed drawn once for both when None); the centroid history
    too."""
    from k210_yolo_framework_tpu.anchors import generate_anchors as jax_gen
    from k210_yolo_framework_tpu_torch.anchors import generate_anchors

    ann = np.load(REPO / "data" / "synth_img_ann.npy", allow_pickle=True)
    if seed is None:
        seed = int(np.random.SeedSequence().entropy % 2**32)
    hist_j, hist_t = [], []
    want = jax_gen(ann, (224, 320), layers, 3, max_iters=iters, seed=seed,
                   history_sink=hist_j)
    got = generate_anchors(ann, (224, 320), layers, 3, max_iters=iters,
                           seed=seed, history_sink=hist_t)
    assert got.shape == (layers, 3, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_array_equal(hist_t[0][0], hist_j[0][0])
    np.testing.assert_allclose(hist_t[0][1], hist_j[0][1], rtol=1e-6)
    assert hist_t[0][1].shape == (iters, layers * 3, 2)


def test_generate_anchors_retries_then_keeps_empty_clusters_like_jax():
    """Two distinct box shapes for six clusters: every random run empties
    a cluster (NaN), so both retry, then run keeping emptied clusters."""
    from k210_yolo_framework_tpu.anchors import generate_anchors as jax_gen
    from k210_yolo_framework_tpu.anchors import kmeans_iou as jax_kmeans
    from k210_yolo_framework_tpu_torch.anchors import (
        generate_anchors,
        kmeans_iou,
    )

    boxes = np.array([[0, 0.5, 0.5, 0.2, 0.3], [1, 0.5, 0.5, 0.6, 0.4]] * 4)
    ann = np.array([np.array(["a.jpg", boxes, np.array([224, 320])],
                             dtype=object)], dtype=object)
    for seed in (0, 5):
        want = jax_gen(ann, (224, 320), 2, 3, seed=seed)
        got = generate_anchors(ann, (224, 320), 2, 3, seed=seed)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-6)
    x = np.array([[0.2, 0.3], [0.6, 0.4]] * 4, np.float32)
    init = np.array([[0.1, 0.1], [0.9, 0.9], [0.2, 0.3]], np.float32)
    for keep in (False, True):
        jc, jidx, jh = jax_kmeans(x, init, iters=3, keep_empty=keep,
                                  return_history=True)
        tc, tidx, th = kmeans_iou(torch.from_numpy(x), torch.from_numpy(init),
                                  iters=3, keep_empty=keep,
                                  return_history=True)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6)
        assert np.isnan(tc.numpy()).any() != keep


def test_draw_detections_takes_boxes_thinner_than_the_outline():
    """Fault r: a box thinner than the outline, or clipped to a sliver by
    the image's edge, made PIL refuse a rectangle whose corners cross (the
    JAX package's ``draw_detections`` still raises); the port draws the
    outline it can and the label."""
    from k210_yolo_framework_tpu.inference import Detections as JDet
    from k210_yolo_framework_tpu.inference import draw_detections as jdraw
    from k210_yolo_framework_tpu_torch.inference import draw_detections

    img = np.zeros((300, 400, 3), np.uint8)       # outline 2 pixels wide
    boxes = np.array([[9.3, -127.5, 86.9, 2.7],   # clipped to 3 columns
                      [50.0, 60.0, 51.0, 200.0],  # one row high
                      [10.0, 10.0, 120.0, 150.0]], np.float32)
    scores = np.array([0.9, 0.8, 0.7], np.float32)
    classes = np.array([1, 2, 3])
    with pytest.raises(ValueError):
        jdraw(img, JDet(boxes, scores, classes))
    out = draw_detections(img, Detections(boxes, scores, classes))
    assert out.shape == img.shape
    assert out[10:121, 10].any() and out[9:88, 0].any()
    assert out[50, 60:200].any()

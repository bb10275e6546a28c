"""The port's benchmark program (``k210_yolo_framework_tpu_torch/bench.py``)
against the repository's root ``bench.py`` (which times the JAX package):
every mode prints one parseable line with the root's metric and keys under
``--device cpu`` at batch 2 and 1-2 iterations (the module's constants,
patched); without a card the module raises; the flags, choices and
defaults are the root's; the dense scene's weights are the root's on the
same (bridged) weights; the train line's FLOP count is the analytic conv
count.  CPU lines are plumbing only: no number here is a card's.
"""

import argparse
import importlib.util
import json
import math
import re
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from k210_yolo_framework_tpu.training.checkpoint import _flatten
from k210_yolo_framework_tpu_torch import bench
from k210_yolo_framework_tpu_torch import config as TConfig
from k210_yolo_framework_tpu_torch.models import build_network
from k210_yolo_framework_tpu_torch.models.layers import Conv
from k210_yolo_framework_tpu_torch.ops import codec as TCodec
from k210_yolo_framework_tpu_torch.training import checkpoint as TC
from k210_yolo_framework_tpu_torch.training import train as TT

from test_torch_predictor import TSPEC
from torch_parity import jax_weights, port_net

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

# the module's constants, cut to a CPU test's size
SMALL = dict(SERVE_BATCH=2, TRAIN_BATCH=2, TRAIN_E2E_BATCH=2, SERVE_ITERS=1,
             LATENCY_CALLS=2, DEVICE_ITERS=2, SCAN_K=2, SCAN_ITERS=1,
             LOADER_IMAGES=8, LOADER_PROBES=1, LOADER_BATCHES=2,
             TRAIN_ITERS=1, ROUNDS=1)

_SERVE = {"metric", "value", "unit", "window_value", "batch",
          "batch_host_rtt_ms_p50", "batch_host_rtt_ms_p99",
          "batch_device_ms", "device"}
_SINGLE = {"single_frame_host_rtt_ms_p50", "single_frame_host_rtt_ms_p99",
           "single_frame_device_ms"}
# mode -> (the root's metric, the line's keys)
LINES = {
    "serve": ("e2e_infer_imgs_per_sec_per_chip", _SERVE | _SINGLE),
    "serve_dual": ("e2e_infer_dual_chain_imgs_per_sec_per_chip",
                   _SERVE | {"chains"}),
    "serve_dense": ("e2e_infer_dense_scene_imgs_per_sec_per_chip",
                    _SERVE | {"dense_scene"}),
    "serve512": ("e2e_infer_512canvas_imgs_per_sec_per_chip", _SERVE),
    "serve_int8": ("e2e_infer_int8w_imgs_per_sec_per_chip", _SERVE),
    "serve_int8act": ("e2e_infer_int8act_imgs_per_sec_per_chip", _SERVE),
    "serve_int8act_sym": ("e2e_infer_int8act_sym_imgs_per_sec_per_chip",
                          _SERVE),
    "serve_int8act_cal": ("e2e_infer_int8act_cal_imgs_per_sec_per_chip",
                          _SERVE),
    "serve_scan": ("device_roofline_infer_imgs_per_sec_per_chip",
                   {"metric", "value", "unit", "window_value", "batch",
                    "scan_k", "cuda_graph", "graph_replays", "device"}),
    "loader": ("loader_e2e_imgs_per_sec_per_chip",
               {"metric", "value", "unit", "batch", "native_loader",
                "host_cores", "host_decode_stage_imgs_per_sec", "h2d_gbps",
                "device"}),
    "train": ("train_imgs_per_sec_per_chip",
              {"metric", "value", "unit", "window_value", "ms_per_step",
               "batch", "model_tflops_per_sec", "mfu_vs_h100_989tflops",
               "device"}),
    "train_e2e": ("train_e2e_imgs_per_sec_per_chip",
                  {"metric", "value", "unit", "window_value", "ms_per_step",
                   "batch", "device"}),
}
ALL = ("serve", "serve512", "serve_int8", "serve_scan", "loader", "train",
       "train_e2e")


@pytest.fixture
def small(monkeypatch):
    for name, value in SMALL.items():
        monkeypatch.setattr(bench, name, value)


def _root_bench():
    """The root ``bench.py`` as a module (it imports only numpy at the
    top)."""
    spec = importlib.util.spec_from_file_location("root_bench",
                                                  REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Parsed(Exception):
    pass


def _parser_of(fn) -> argparse.ArgumentParser:
    """The parser ``fn()`` builds, caught as it parses."""
    seen = []

    def grab(self, *_args, **_kwargs):
        seen.append(self)
        raise _Parsed

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab):
        with pytest.raises(_Parsed):
            fn()
    return seen[0]


def _options(parser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default,
                     None if a.choices is None else tuple(a.choices), a.type)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("mode", list(LINES) + ["all"])
def test_each_mode_prints_one_line_with_the_roots_keys(mode, small, capsys):
    got = bench.main(["--mode", mode, "--device", "cpu"])
    printed = [l for l in capsys.readouterr().out.splitlines()
               if l.startswith("{")]
    assert [json.loads(l) for l in printed] == got
    modes = ALL if mode == "all" else (mode,)
    assert len(got) == len(modes)
    for line, m in zip(got, modes):
        metric, keys = LINES[m]
        assert line["metric"] == metric
        assert set(line) == keys, m
        assert line["device"] == {"name": "cpu"}
        assert line["unit"] == "imgs/sec" and line["batch"] == 2
        assert math.isfinite(line["value"]) and line["value"] > 0
        # all rounds' work over their time: no faster than the best round
        assert line.get("window_value", 0) <= line["value"]
    if mode == "serve_scan":
        assert got[0]["scan_k"] == 2 and got[0]["cuda_graph"] is False
        assert got[0]["graph_replays"] == 0
    if mode == "serve_dual":
        assert got[0]["chains"] == 2


def test_without_a_card_the_module_raises():
    """``--device`` defaults to cuda: with no card the module raises and
    prints no line (nothing falls back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("the refusal is that of a machine without a card")
    proc = subprocess.run(
        [sys.executable, "-m", "k210_yolo_framework_tpu_torch.bench"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "no CUDA device" in proc.stderr
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--mode", "train"])


def test_flags_choices_and_defaults_are_the_roots(capsys):
    """The root parser's every option (names, defaults, choices, types),
    caught from its ``main``, and the port's, plus ``--device``; and the
    same options and choices in both ``--help`` texts."""
    root = _options(_parser_of(_root_bench().main))
    port = _options(_parser_of(lambda: bench.parse_args([])))
    assert port.pop("device") == (("--device",), "cuda", None, None)
    assert port == root

    proc = subprocess.run([sys.executable, "bench.py", "--help"], cwd=REPO,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    with pytest.raises(SystemExit):
        bench.parse_args(["--help"])
    port_help = capsys.readouterr().out

    def flags_and_choices(text):
        return (set(re.findall(r"--\w+", text)),
                set(re.findall(r"\{[\w,]+\}", text)))

    root_flags, root_choices = flags_and_choices(proc.stdout)
    port_flags, port_choices = flags_and_choices(port_help)
    assert port_flags == root_flags | {"--device"}
    assert port_choices == root_choices
    assert len(root_choices) == 2 and "--mode" in root_flags


@pytest.mark.parametrize("model_def", ["yolo_mobilev1", "yolo"])
def test_demo_spec_is_the_roots(model_def, monkeypatch):
    root = _root_bench()
    monkeypatch.setattr(root, "MODEL_DEF", model_def)
    want, got = root._demo_spec(), bench._demo_spec(model_def)
    assert got.in_hw == tuple(want.in_hw)
    assert [tuple(h) for h in got.out_hws] == [tuple(h)
                                               for h in want.out_hws]
    assert got.class_num == want.class_num
    np.testing.assert_array_equal(got.anchors_np(),
                                  np.asarray(want.anchors, np.float32))
    assert tuple(bench._staging_canvas_hw()) == tuple(
        root._staging_canvas_hw())


def test_dense_scene_state_is_the_roots_on_bridged_weights():
    """``_dense_scene_state`` on weights bridged from a JAX set equals the
    bridged result of the root's ``_dense_scene_variables`` on that set,
    bit for bit."""
    root = _root_bench()
    spec = bench._demo_spec()
    _, variables, flat = jax_weights("yolo_mobilev1", spec.in_hw,
                                     spec.nanchors, spec.class_num,
                                     alpha=bench.ALPHA)
    bumped = root._dense_scene_variables(mock.Mock(variables=variables))
    want_flat = {f"{g}/{k}": np.asarray(v) for g in ("params", "batch_stats")
                 for k, v in _flatten(bumped[g]).items()}
    net = port_net("yolo_mobilev1", spec.in_hw, spec.nanchors,
                   spec.class_num, alpha=bench.ALPHA, flat=flat)
    got = bench._dense_scene_state(net, spec)
    want = TC.state_dict_from_flat(want_flat, net)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    changed = [k for k in want if not torch.equal(want[k],
                                                  net.state_dict()[k])]
    assert len(changed) == 2 and all(k.endswith("dark_conv_out.bias")
                                     for k in changed)


def test_train_step_flops_are_the_analytic_conv_count():
    """``_step_flops`` of a train step at the small parity config equals
    the convs' multiply-adds x 2 from the net's shapes: forward, the input
    gradient (not the stem's: the images need none) and the weight
    gradient, each the same product.  torch's own conv-backward formula
    counts a depthwise conv's weight gradient over every channel: more."""
    net = build_network("yolo_mobilev1", TSPEC.in_hw, TSPEC.nanchors,
                        TSPEC.class_num, alpha=0.25)
    cfg = TConfig.TrainConfig(batch_size=2)
    state = TT.create_train_state(net, cfg, "cpu")
    step = TT.make_train_step(TSPEC, cfg)
    rng = np.random.default_rng(0)
    boxes = np.concatenate([
        rng.integers(0, TSPEC.class_num, (2, 4, 1)).astype(np.float32),
        rng.uniform(0.2, 0.8, (2, 4, 2)),
        rng.uniform(0.1, 0.4, (2, 4, 2))], -1).astype(np.float32)
    labels = tuple(TCodec.encode_labels_batch(
        torch.from_numpy(boxes), torch.ones((2, 4), dtype=torch.bool),
        TSPEC))
    images = torch.from_numpy(
        rng.uniform(0, 1, (2, *TSPEC.in_hw, 3)).astype(np.float32))
    products = []

    def record(conv, _args, out):
        products.append((conv is net.stem.conv,
                         2 * out.numel() * conv.weight[0].numel()))

    hooks = [m.register_forward_hook(record) for m in net.modules()
             if isinstance(m, Conv)]
    try:
        _, flops = bench._step_flops(step, state, images, labels)
    finally:
        for h in hooks:
            h.remove()
    assert len(products) == sum(isinstance(m, Conv) for m in net.modules())
    assert sum(stem for stem, _ in products) == 1
    assert flops == sum(f * (2 if stem else 3) for stem, f in products)

    with FlopCounterMode(display=False) as stock:
        step(state, images, labels)
    assert stock.get_total_flops() > flops

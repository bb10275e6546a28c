"""The result line's shape, and the command's refusals: no card, or a
checkout that holds only the benchmark."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from yolo_bench import run as R
from yolo_bench.tests import _small

ROOT = Path(R.__file__).resolve().parent.parent
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", sorted(_small.SMALL))
@pytest.mark.parametrize("trace", [False, True], ids=["t0", "t1"])
def test_line_keys_and_metrics(name, trace):
    line = _small.run(name, trace=trace)
    line.pop("detail")                  # main() prints it on stderr
    want = KEYS + (["breakdown"] if trace else []) + ["check"]
    assert list(line) == want
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    cell = _small.cell(name)
    named = {m["name"]: m for m in (cell.per_layer if trace
                                    else cell.end_to_end)}
    assert set(line["metrics"]) <= set(named)
    for k, v in line["metrics"].items():
        assert v["unit"] == named[k]["unit"]
        assert v["value"] == v["value"]              # not NaN
    if not trace:                   # every end-to-end metric is read
        assert set(line["metrics"]) == set(named)
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in line["check"].values():
        assert set(c) == {"value", "limit"}


# what each small cell's check compared at seed 5, and the served and
# reference detections behind a serving cell's share.  Traced, the window
# makes at least ``trace_start + trace_calls`` calls, so every pool batch
# is among its answers however slow the host is.
PINNED = {
    "v1-serve-b128": ({"off_share": 0.0}, {"served": 97, "reference": 102}),
    "yolov3-608-eval-b32": ({"off_share": 0.0074375},
                            {"served": 8000, "reference": 8000}),
    "v1-train-b128": ({"loss_gap": 0.001001605632866481,
                       "grad_median_gap": 0.004794981119466132,
                       "change_gap": 0.03038773865147507}, {}),
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_the_small_cells_check_the_same_numbers(name):
    line = _small.run(name, trace=True)
    numbers, detail = PINNED[name]
    got = {k: v["value"] for k, v in line["check"].items()}
    assert got == pytest.approx(numbers, rel=1e-6, abs=1e-12)
    assert {k: line["detail"][k] for k in detail} == detail


def _command(cwd, *extra):
    return subprocess.run(
        [sys.executable, "-m", "yolo_bench.run", "--workload",
         "v1-serve-b128", "--seed", "1", "--seconds", "1", "--trace", "0",
         *extra], cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    """Where torch has no CUDA the command exits 1 and prints no
    line; it never runs on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is here: the refusal is not reachable")
    proc = _command(ROOT)
    assert proc.returncode == 1
    assert proc.stdout.strip() == ""
    assert "needs 1 CUDA device" in proc.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "yolo_bench", tmp_path / "yolo_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _command(tmp_path)
    assert proc.returncode != 0
    assert not any(ln.startswith("{") for ln in proc.stdout.splitlines())


def test_seeds_past_32_bits_and_same_seed_same_inputs():
    import torch

    from yolo_bench import traffic
    tr = _small.cell("v1-train-b128").traffic
    a = traffic.make(tr, 2**31 + 12345, torch.device("cpu"))
    b = traffic.make(tr, 2**31 + 12345, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)

"""Every file the benchmark finds by name loads, and BENCHMARK.json keeps to
the benchmark contract's shape: keys, names, units, lengths, limits."""

import json
import re
from pathlib import Path

import pytest

from yolo_bench import run as R

ROOT = Path(R.__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "-m", "yolo_bench.run"]
    assert BENCH["paths"] == ["yolo_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("yolo_bench/configs/")
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert body["reduced"] == c["reduced"] == []
        assert c["name"] in used


def test_workloads():
    assert len(set(CELLS)) == len(CELLS)
    assert len({(w["config"], w["traffic"])
                for w in BENCH["workloads"]}) == len(CELLS)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
        cell = R.Cell(w["name"], BENCH)
        assert (ROOT / "yolo_bench" / "entries"
                / f"{cell.traffic['entry']}.py").exists()
        assert cell.check["limits"]
        ends = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in ends and len(ends) >= 2
        assert cell.per_layer


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    ends = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH[kind]:
        allowed = {"name", "unit", "better", "source", "workloads"}
        allowed |= ({"bound"} if kind == "end_to_end"
                    else {"layer", "moves"})
        assert set(m) <= allowed and NAME.match(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        assert (ROOT / "yolo_bench" / "metrics" / f"{m['name']}.py").exists()
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert _line(m["layer"]) and m["moves"] in ends
            assert "workloads" in m
            moved = next(e for e in BENCH["end_to_end"]
                         if e["name"] == m["moves"])
            assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
    if kind == "end_to_end":
        assert "setup_s" in ends


def test_every_harness_file_is_named_from_name_characters():
    for path in (ROOT / "yolo_bench").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel

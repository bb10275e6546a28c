"""The benchmark of the PyTorch and CUDA port, one cell a run:

    python -m yolo_bench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout, on a machine with a CUDA card; with none it
exits 1 and prints no result.  A run loads the cell's files (the cell in
``BENCHMARK.json``, ``configs/<config>.json``, ``traffic/<traffic>.json``,
``workloads/<cell>.json``), makes the weights and inputs on the card from
the seed, warms up the cell's own shapes, drives the entry named by the
traffic file (``entries/<kind>.py``) in a closed loop for ``--seconds``,
checks what the window produced against the plain reference
(``reference/``), and prints one JSON line last on standard output.

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones: every metric of ``BENCHMARK.json`` whose
``workloads`` name the cell, each read by ``metrics/<name>.py``.  The
numbers the check compared, each beside its limit, come last in the line
(``check``) and last on standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional, Sequence  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the top-level module names no run may load (whole names: the port's name
# begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "k210_yolo_framework_tpu")


def _fixed_caches() -> None:
    """Every build and kernel cache at a fixed path in the checkout: the
    port's CUDA libraries already build into its ``_build/``; Triton's and
    torch's extension caches, should anything use them, go here.  Host
    work on one thread: the run is one process, and the card's host is
    shared, so a pool of spinning threads only adds noise."""
    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A harness file found by name (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One cell's files, found by the names in ``BENCHMARK.json``."""

    def __init__(self, name: str, bench: Optional[dict] = None,
                 overrides: Optional[dict] = None):
        bench = bench or load_json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; have "
                             f"{sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        self.config = load_json(HERE / "configs" /
                                f"{self.entry['config']}.json")
        self.traffic = load_json(HERE / "traffic" /
                                 f"{self.entry['traffic']}.json")
        self.check = load_json(HERE / "workloads" / f"{name}.json")
        for key, value in (overrides or {}).items():
            getattr(self, key).update(value)

        def mine(m):
            return "workloads" not in m or name in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]


def forbidden_loaded() -> List[str]:
    """Top-level names of loaded modules that no run may load."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def device_of(torch, want: str = "cuda", chips: int = 1):
    """The card the run uses; with no CUDA card, or fewer than the cell
    asks for, exit 1 (nothing falls back to the CPU)."""
    if want != "cuda":
        return torch.device(want)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"yolo_bench: needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        raise SystemExit(1)
    return torch.device("cuda", 0)


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device) -> dict:
    """Set up, drive the window, check; returns the result line (without
    printing)."""
    import torch

    from yolo_bench import trace as TR

    kind = load_module(HERE / "entries" / f"{cell.traffic['entry']}.py",
                       f"yolo_bench_entry_{cell.traffic['entry']}")
    entry = kind.Entry(cell, seed, device, trace)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    prof = None
    if trace:
        prof = TR.Profiled(device, int(cell.traffic["trace_start"]),
                           int(cell.traffic["trace_calls"]))
    calls: List[tuple] = []
    t_first = time.perf_counter()
    setup_s = t_first - T_START
    i = 0
    while True:
        t0 = time.perf_counter()
        if prof is not None:
            prof.before(i)
        with TR.span("call", trace):
            entry.call(i)
        if prof is not None:
            prof.after(i)
        calls.append((t0, time.perf_counter()))
        i += 1
        if calls[-1][1] - t_first >= seconds and (prof is None or prof.done):
            break
    entry.drain()
    t_end = time.perf_counter()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    window = {"t0": t_first, "t1": t_end, "calls": calls,
              "images_per_call": entry.images_per_call}
    summary = None
    if prof is not None:
        summary = TR.summarize(prof, prof.count,
                               prof.count * entry.images_per_call)
    entry.free()
    compared = entry.check()
    counts = entry.counts()
    found = forbidden_loaded()
    if found:
        print(f"yolo_bench: forbidden modules loaded: {found}",
              file=sys.stderr)
        raise SystemExit(3)

    record = {"setup_s": setup_s, "window": window, "trace": summary,
              "counts": counts, "config": cell.config,
              "traffic": cell.traffic}
    metrics: Dict[str, dict] = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                             "yolo_bench_metric_" + m["name"].replace(
                                 ".", "_"))
        value = reader.read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(v <= lim for v, lim in compared.values())
    line = {"correct": correct, "attempted": len(calls), "failed": 0,
            "metrics": metrics, "device": _device_record(torch, device, peak,
                                                         summary)}
    if summary is not None:
        line["breakdown"] = TR.breakdown(summary)
    line["detail"] = getattr(entry, "detail", {})   # main() prints it apart
    line["check"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in compared.items()}
    return line


def _device_record(torch, device, peak: int, summary) -> dict:
    if device.type == "cuda":
        rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": 1, "memory_peak_bytes": int(peak)}
    else:
        rec = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if summary is not None:
        rec["busy_s"] = summary["busy_s"]
        rec["window_s"] = summary["window_s"]
    return rec


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m yolo_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    _fixed_caches()
    cell = Cell(args.workload)
    import torch

    torch.set_num_threads(1)
    device = device_of(torch, "cuda", int(cell.entry["chips"]))
    line = run(cell, args.seed, args.seconds, bool(args.trace), device)
    print(f"detail {json.dumps(line.pop('detail'))}", file=sys.stderr)
    for name, c in line["check"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

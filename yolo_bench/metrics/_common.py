"""Helpers the metric readers share (a reader is ``metrics/<name>.py``
with ``read(record) -> float | None``; ``record`` holds ``setup_s``,
``window`` (host-clock call times), ``trace`` (the traced stretch's
summary, ``trace.summarize``, the port's own spans under its ``program``;
None untraced), ``counts``, ``config`` and ``traffic``)."""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Callable, Optional

from yolo_bench import counts as C


def reader_of(name: str) -> Callable[[dict], Optional[float]]:
    """The ``read`` of ``metrics/<name>.py``: for a metric that reads what
    another reads, in cells that report another end-to-end metric."""
    path = Path(__file__).with_name(f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "yolo_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_call_ms(record: dict, seconds: float) -> Optional[float]:
    tr = record["trace"]
    if tr is None or tr["calls"] == 0:
        return None
    return seconds / tr["calls"] * 1e3


def kernel_s(record: dict, fragment: str) -> float:
    """Device seconds of the kernels whose name holds ``fragment``."""
    return sum(s for name, s in record["trace"]["device_ops"].items()
               if fragment in name)


def idle_share(record: dict) -> Optional[float]:
    tr = record["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def mfu(record: dict, flops_per_image: float) -> Optional[float]:
    """The traced stretch's conv FLOPs over its length, as a share of the
    configuration's dense tensor-core peak."""
    tr = record["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    peak = C.PEAK_FLOPS[record["config"]["precision"]]
    return 100.0 * flops_per_image * tr["images"] / tr["window_s"] / peak


def roofline(record: dict, fragment: str, work: dict) -> Optional[float]:
    """A kernel's bound over its traced time, both over the traced calls;
    None where the kernel never ran."""
    tr = record["trace"]
    spent = kernel_s(record, fragment) if tr else 0.0
    if spent <= 0:
        return None
    bound = C.bound_s(work["bytes"], work["ops"], C.H100_FP32_FLOPS)
    return 100.0 * bound * tr["calls"] / spent

"""Spans and the profiler: what a ``--trace 1`` run records, and the summary
the per-layer metric readers read.

The spans are the harness's own ``record_function`` ranges, named
``yb.<layer>``, around the calls it makes into the program (the entry call,
the net's forward through hooks on the net, the preprocess function it
hands the train step).  ``torch.profiler`` records the device's kernels,
copies and sets and the host's operations over a stretch of the window;
:func:`summarize` reduces them to plain numbers, so nothing of the trace is
written to disk.

A device event is attributed to the innermost ``yb.*`` span, on the
launching thread, that holds the host event that launched it.  Kernels that
the program launches through its own CUDA libraries (``ctypes``) have no
host event; they are read by name.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch

PREFIX = "yb."


@contextmanager
def span(name: str, on: bool):
    """A ``yb.<name>`` range while ``on``; nothing otherwise."""
    if not on:
        yield
        return
    with torch.profiler.record_function(PREFIX + name):
        yield


def hook_spans(module: torch.nn.Module, name: str) -> None:
    """A ``yb.<name>`` range around every forward of ``module``."""
    open_ranges: List = []

    def pre(_mod, _args):
        rf = torch.profiler.record_function(PREFIX + name)
        rf.__enter__()
        open_ranges.append(rf)

    def post(_mod, _args, _out):
        open_ranges.pop().__exit__(None, None, None)

    module.register_forward_pre_hook(pre)
    module.register_forward_hook(post)


class Profiled:
    """The profiler over the window's calls [start, start + count): the
    entry calls :meth:`before` and :meth:`after` around each call."""

    def __init__(self, device: torch.device, start: int, count: int):
        self.device, self.start, self.count = device, start, count
        self.prof = None
        self.t0 = self.t1 = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def before(self, i: int) -> None:
        if i == self.start:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._sync()
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self.t0 = time.perf_counter()

    def after(self, i: int) -> None:
        if self.prof is not None and self.t1 is None \
                and i == self.start + self.count - 1:
            self._sync()
            self.t1 = time.perf_counter()
            self.prof.__exit__(None, None, None)

    @property
    def done(self) -> bool:
        return self.t1 is not None


def _is_device(ev) -> bool:
    from torch.autograd import DeviceType
    return ev.device_type == DeviceType.CUDA


def _is_annotation(ev) -> bool:
    return ev.name.startswith(PREFIX) or bool(
        getattr(ev, "is_user_annotation", False))


def _kind(name: str) -> str:
    """``"copy"`` (a memcpy), ``"set"`` (a memset) or ``"kernel"``."""
    low = name.lower()
    return ("copy" if low.startswith("memcpy") else
            "set" if low.startswith("memset") else "kernel")


def _union(intervals: List[tuple]) -> List[tuple]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def summarize(prof: Profiled, calls: int, images: int) -> dict:
    """The traced stretch as numbers (seconds unless named otherwise):
    ``window_s`` (host clock, both ends synchronised), ``busy_s`` (the
    union of the device's events), ``calls``, ``images``, ``device_ops``
    {name: s}, ``launches`` (kernels, not copies or sets), ``copies_s``
    (memcpys), ``spans`` {span: {"device_s" (kernels and sets),
    "launches", "copies_s", "ops" {name: s}}} of the events launched
    inside each span, and ``idle_gaps`` {what the host was doing:
    s}."""
    events = prof.prof.events()
    dev = [e for e in events if _is_device(e) and not _is_annotation(e)]
    host = [e for e in events if not _is_device(e)]
    ops: Dict[str, float] = defaultdict(float)
    launches, copies = 0, 0.0
    for e in dev:
        dur = e.time_range.elapsed_us() / 1e6
        ops[e.name] += dur
        kind = _kind(e.name)
        copies += dur if kind == "copy" else 0.0
        launches += kind == "kernel"
    busy = _union([(e.time_range.start, e.time_range.end) for e in dev])

    # host spans, by thread, to attribute launches and name idle gaps
    by_thread: Dict[int, List] = defaultdict(list)
    for e in host:
        if e.name.startswith(PREFIX):
            by_thread[e.thread].append((e.time_range.start, e.time_range.end,
                                        e.name[len(PREFIX):]))
    for v in by_thread.values():
        v.sort()

    starts = {t: [a for a, _, _ in v] for t, v in by_thread.items()}

    def innermost(thread: int, t: float) -> Optional[str]:
        """The latest-starting span on ``thread`` that holds ``t`` (spans
        nest, so a few steps back reach it)."""
        v = by_thread.get(thread)
        if not v:
            return None
        j = bisect.bisect_right(starts[thread], t)
        for a, b, name in reversed(v[max(0, j - 8):j]):
            if a <= t <= b:
                return name
        return None

    spans: Dict[str, dict] = defaultdict(
        lambda: {"device_s": 0.0, "launches": 0, "copies_s": 0.0,
                 "ops": defaultdict(float)})
    for e in host:
        kernels = getattr(e, "kernels", None) or ()
        if not kernels:
            continue
        name = innermost(e.thread, e.time_range.start)
        if name is None:
            continue
        rec = spans[name]
        for k in kernels:
            dur = k.duration / 1e6
            rec["ops"][k.name] += dur
            kind = _kind(k.name)
            if kind == "copy":
                rec["copies_s"] += dur
            else:
                rec["device_s"] += dur
                rec["launches"] += kind == "kernel"

    # idle gaps, named by the innermost host operation under way on the
    # thread that makes the calls: a sweep over its nested operations
    main = max(by_thread, key=lambda t: len(by_thread[t]), default=None)
    ops_main = sorted((e.time_range.start, e.time_range.end, e.name)
                      for e in host if e.thread == main)
    gaps: Dict[str, float] = defaultdict(float)
    stack: List[tuple] = []
    j = 0
    for (_, b), (a2, _) in zip(busy, busy[1:]):
        mid = (b + a2) / 2
        while j < len(ops_main) and ops_main[j][0] <= mid:
            while stack and stack[-1][0] < ops_main[j][0]:
                stack.pop()
            stack.append((ops_main[j][1], ops_main[j][2]))
            j += 1
        while stack and stack[-1][0] < mid:
            stack.pop()
        gaps[stack[-1][1] if stack else "host idle"] += (a2 - b) / 1e6
    return {"window_s": prof.t1 - prof.t0,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "calls": calls, "images": images,
            "device_ops": dict(ops), "launches": launches,
            "copies_s": copies,
            "spans": {k: dict(v, ops=dict(v["ops"])) for k, v in
                      spans.items()},
            "idle_gaps": dict(gaps)}


def breakdown(summary: dict) -> dict:
    """The contract's ``breakdown``: the ten device operations that took
    most time and the ten largest idle totals by host operation, in
    seconds over the traced stretch."""
    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:10]]
    return {"device_ops": top(summary["device_ops"]),
            "idle_gaps": top(summary["idle_gaps"])}

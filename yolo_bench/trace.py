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

The program's own spans, ``k210.<stage>`` (the port's ``utils/trace.span``,
entered only while a profiler records), are summed apart by
:func:`program_spans` under the summary's ``program``, with the device's
idle time inside each: what a ``program_span`` metric reads.
"""

from __future__ import annotations

import bisect
import re
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


PROGRAM_PREFIX = "k210."

# The profiler's own bookkeeping on the host (kineto's names)
_PROFILER_OVERHEAD = ("Activity Buffer Request", "Buffer Flush")


def _bookkeeping(ev) -> bool:
    """A CUDA runtime or driver call (``cudaFuncSetAttribute``,
    ``cuLaunchKernelEx``) or the profiler's own overhead.  Such an event
    launches no torch op's kernels; where one ran outside every op,
    ``torch.profiler`` keys it by its CUDA correlation id among the ops'
    ids and may hand it an unrelated op's kernels, a second copy of
    them."""
    return (ev.name.startswith(_PROFILER_OVERHEAD)
            or re.match(r"cu(da)?[A-Z]", ev.name) is not None)


class _Span:
    """One program span on one thread; ``parent`` the innermost span on
    that thread that holds it."""
    __slots__ = ("a", "b", "name", "parent", "child_us")

    def __init__(self, a: float, b: float, name: str, parent):
        self.a, self.b, self.name, self.parent = a, b, name, parent
        self.child_us = 0.0


def _nest(events) -> List[_Span]:
    """One thread's program spans, by start, each with its parent."""
    out: List[_Span] = []
    stack: List[_Span] = []
    for a, b, name in sorted(events, key=lambda x: (x[0], -x[1])):
        while stack and b > stack[-1].b:    # not inside: a sibling's
            stack.pop()
        sp = _Span(a, b, name, stack[-1] if stack else None)
        if sp.parent is not None:
            sp.parent.child_us += b - a
        out.append(sp)
        stack.append(sp)
    return out


def _innermost(spans: List[_Span], starts: List[float],
               t: float) -> Optional[_Span]:
    """The latest-starting span that holds ``t``: from the last span to
    start by ``t``, up its parents."""
    j = bisect.bisect_right(starts, t) - 1
    sp = spans[j] if j >= 0 else None
    while sp is not None and not sp.a <= t <= sp.b:
        sp = sp.parent
    return sp


def _self_intervals(spans: List[_Span]) -> List[tuple]:
    """(a, b, span) over the thread's time, where ``span`` is the
    innermost program span open: each span's range less its children's."""
    kids: Dict[int, List[_Span]] = defaultdict(list)
    for sp in spans:
        if sp.parent is not None:
            kids[id(sp.parent)].append(sp)
    out = []
    for sp in spans:
        t = sp.a
        for kid in kids[id(sp)]:            # by start, disjoint
            if kid.a > t:
                out.append((t, kid.a, sp))
            t = max(t, kid.b)
        if sp.b > t:
            out.append((t, sp.b, sp))
    return sorted(out, key=lambda x: x[0])


def program_spans(events) -> Dict[str, dict]:
    """The program's spans (``k210.*``) among a profiler's ``events``, by
    name (the prefix dropped), in seconds: ``count``; ``host_s``, their
    summed durations; ``self_s``, those less what nested program spans
    cover; ``device_s`` (kernels and sets), ``launches`` (kernels) and
    ``copies_s`` (memcpys) of the device events launched inside the span,
    nested spans included; ``idle_s``, the device-idle time (the gaps
    between the device's events, and before the first and after the last
    within the host's events) that falls inside the span while no nested
    program span is open, each gap split at the span boundaries.

    A launch belongs to the innermost program span open at its host
    event's start on the launching thread; from a thread with no program
    span (autograd's backward thread), to the innermost one holding that
    time on the calling thread, the one with the most program spans, whose
    spans also split the idle gaps.  Kernels with no host event (the
    program's ``ctypes`` libraries) belong to no span, and those the
    profiler hands a runtime call or its own overhead
    (:func:`_bookkeeping`) count nowhere.  The device's copies of the
    ranges (user annotations) are no device time.  Empty where the
    program has no spans."""
    dev = [e for e in events if _is_device(e) and not _is_annotation(e)]
    host = [e for e in events if not _is_device(e)]
    busy = _union([(e.time_range.start, e.time_range.end) for e in dev])
    by_thread: Dict[int, List[tuple]] = defaultdict(list)
    for e in host:
        if e.name.startswith(PROGRAM_PREFIX):
            by_thread[e.thread].append((e.time_range.start,
                                        e.time_range.end,
                                        e.name[len(PROGRAM_PREFIX):]))
    if not by_thread:
        return {}
    nested = {t: _nest(v) for t, v in by_thread.items()}
    starts = {t: [sp.a for sp in v] for t, v in nested.items()}
    main = max(nested, key=lambda t: len(nested[t]))

    out: Dict[str, dict] = {}

    def rec(name: str) -> dict:
        if name not in out:
            out[name] = {"count": 0, "host_s": 0.0, "self_s": 0.0,
                         "device_s": 0.0, "launches": 0, "copies_s": 0.0,
                         "idle_s": 0.0}
        return out[name]

    for spans in nested.values():
        for sp in spans:
            r = rec(sp.name)
            r["count"] += 1
            r["host_s"] += (sp.b - sp.a) / 1e6
            r["self_s"] += (sp.b - sp.a - sp.child_us) / 1e6

    for e in host:
        kernels = getattr(e, "kernels", None) or ()
        if not kernels or _bookkeeping(e):
            continue
        thread = e.thread if e.thread in nested else main
        sp = _innermost(nested[thread], starts[thread], e.time_range.start)
        while sp is not None:              # the span and every enclosing one
            r = rec(sp.name)
            for k in kernels:
                dur = k.duration / 1e6
                kind = _kind(k.name)
                if kind == "copy":
                    r["copies_s"] += dur
                else:
                    r["device_s"] += dur
                    r["launches"] += kind == "kernel"
            sp = sp.parent

    lo = min(e.time_range.start for e in host)
    hi = max(e.time_range.end for e in host)
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    selfs = _self_intervals(nested[main])
    j = 0
    for a, b in gaps:
        while j < len(selfs) and selfs[j][1] <= a:
            j += 1
        k = j
        while k < len(selfs) and selfs[k][0] < b:
            lap = min(b, selfs[k][1]) - max(a, selfs[k][0])
            if lap > 0:
                rec(selfs[k][2].name)["idle_s"] += lap / 1e6
            k += 1
    return out


def summarize(prof: Profiled, calls: int, images: int) -> dict:
    """The traced stretch as numbers (seconds unless named otherwise):
    ``window_s`` (host clock, both ends synchronised), ``busy_s`` (the
    union of the device's events), ``calls``, ``images``, ``device_ops``
    {name: s}, ``launches`` (kernels, not copies or sets), ``copies_s``
    (memcpys), ``spans`` {span: {"device_s" (kernels and sets),
    "launches", "copies_s", "ops" {name: s}}} of the events launched
    inside each span, and ``idle_gaps`` {what the host was doing:
    s}, and ``program``, :func:`program_spans` of the same events."""
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
            "idle_gaps": dict(gaps),
            "program": program_spans(events)}


def breakdown(summary: dict) -> dict:
    """The contract's ``breakdown``: the ten device operations that took
    most time and the ten largest idle totals by host operation, in
    seconds over the traced stretch."""
    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:10]]
    return {"device_ops": top(summary["device_ops"]),
            "idle_gaps": top(summary["idle_gaps"])}

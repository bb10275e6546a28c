"""The program's own spans in a traced run: which stage of the serving entry
or the train step launched each device event, and inside which stage the
device sat idle.

    python -m yolo_bench.program --workload <cell> --seed <n> [--seconds 5]

runs the cell traced, as ``python -m yolo_bench.run --trace 1`` does, prints
that run's result line and then one JSON line of :func:`program_spans` over
the traced stretch, in ms a call (a step), with the share of the device's
idle time that fell inside some program span.  The benchmark's own runs do
not run this: a metric reader gets ``trace.summarize``'s summary, which
holds no program spans.

The port names its spans ``k210.<stage>`` (its ``utils/trace.span``),
entered only while a profiler records; a commit of the port without them
gives an empty table.
"""

from __future__ import annotations

import argparse
import bisect
import json
import re
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

from yolo_bench import run as R
from yolo_bench import trace as TR

PREFIX = "k210."

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
    dev = [e for e in events if TR._is_device(e) and not TR._is_annotation(e)]
    host = [e for e in events if not TR._is_device(e)]
    busy = TR._union([(e.time_range.start, e.time_range.end) for e in dev])
    by_thread: Dict[int, List[tuple]] = defaultdict(list)
    for e in host:
        if e.name.startswith(PREFIX):
            by_thread[e.thread].append((e.time_range.start,
                                        e.time_range.end,
                                        e.name[len(PREFIX):]))
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
                kind = TR._kind(k.name)
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


def per_call(program: Dict[str, dict], summary: dict) -> dict:
    """``program`` a call: the seconds as ms (``host_ms``, ...), ``count``
    and ``launches`` as they are; with the device's busy and idle ms a
    call over the stretch and the share of the idle inside some span."""
    calls = summary["calls"]
    idle_s = summary["window_s"] - summary["busy_s"]
    spans = {name: {(k if k in ("count", "launches") else k[:-2] + "_ms"):
                    (v if k in ("count", "launches") else v / calls * 1e3)
                    for k, v in r.items()}
             for name, r in sorted(program.items())}
    inside = sum(r["idle_s"] for r in program.values())
    return {"calls": calls, "busy_ms": summary["busy_s"] / calls * 1e3,
            "idle_ms": idle_s / calls * 1e3,
            "idle_in_span": inside / idle_s if idle_s > 0 else None,
            "spans": spans}


def traced(cell: R.Cell, seed: int, seconds: float, device) -> tuple:
    """``run.run`` of the cell traced; its line and :func:`per_call` of
    the traced stretch's program spans."""
    seen = {}
    summarize = TR.summarize

    def keep(prof, calls, images):
        seen["summary"] = summarize(prof, calls, images)
        seen["program"] = program_spans(prof.prof.events())
        return seen["summary"]

    TR.summarize = keep
    try:
        line = R.run(cell, seed, seconds, True, device)
    finally:
        TR.summarize = summarize
    return line, per_call(seen["program"], seen["summary"])


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m yolo_bench.program")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    R._fixed_caches()
    cell = R.Cell(args.workload)
    import torch

    torch.set_num_threads(1)
    device = R.device_of(torch, "cuda", int(cell.entry["chips"]))
    line, table = traced(cell, args.seed, args.seconds, device)
    line.pop("detail")
    print(json.dumps(line), flush=True)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      **table}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

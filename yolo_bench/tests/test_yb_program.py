"""``trace.program_spans`` on synthetic event lists: which span a launch
and an idle gap belong to, nesting, a launch from another thread; the
trace summary's other keys the same with the program's spans present or
not, and as they were before it held ``program``; the small cells traced
on the CPU, with their spans once a call."""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from yolo_bench import program as P
from yolo_bench import trace as TR
from yolo_bench.tests import _small

MAIN, AUTOGRAD = 1, 2


class _Range:
    def __init__(self, a, b):
        self.start, self.end = a, b

    def elapsed_us(self):
        return self.end - self.start


def _host(name, a, b, thread=MAIN, kernels=()):
    return SimpleNamespace(
        name=name, device_type=DeviceType.CPU, thread=thread,
        time_range=_Range(a, b), is_user_annotation=False,
        kernels=[SimpleNamespace(name=k, duration=d) for k, d in kernels])


def _dev(name, a, b, annotation=False):
    return SimpleNamespace(name=name, device_type=DeviceType.CUDA,
                           thread=0, time_range=_Range(a, b),
                           is_user_annotation=annotation, kernels=[])


def _events(program=True):
    """One serving call and one train step's backward, in microseconds.

    Host, main thread: yb.call [-1, 100] holds k210.serve.batch [0, 100],
    which holds h2d [0, 10], net [10, 40] (with a conv launched at 12),
    head [40, 60] (a flatten at 41) and d2h [60, 70]; then
    k210.train.backward [100, 140] with autograd's thread launching a
    kernel at 110.  Device: copy [5, 15], conv [20, 30], flatten
    [45, 50], copy [62, 66], backward kernel [115, 135].
    """
    host = [_host("yb.call", -1, 100),
            _host("aten::to", 1, 9, kernels=[("Memcpy HtoD", 10.0)]),
            _host("aten::conv2d", 12, 14, kernels=[("conv_kernel", 10.0)]),
            _host("aten::flatten", 41, 43, kernels=[("flat_kernel", 5.0)]),
            _host("aten::copy_", 61, 67, kernels=[("Memcpy DtoH", 4.0)]),
            _host("aten::mul", 110, 112, thread=AUTOGRAD,
                  kernels=[("bwd_kernel", 20.0)])]
    if program:
        host += [_host("k210.serve.batch", 0, 100),
                 _host("k210.serve.h2d", 0, 10),
                 _host("k210.serve.net", 10, 40),
                 _host("k210.serve.head", 40, 60),
                 _host("k210.serve.d2h", 60, 70),
                 _host("k210.train.backward", 100, 140)]
    dev = [_dev("Memcpy HtoD", 5, 15), _dev("conv_kernel", 20, 30),
           _dev("flat_kernel", 45, 50), _dev("Memcpy DtoH", 62, 66),
           _dev("bwd_kernel", 115, 135)]
    if program:     # the device's copies of the user ranges
        dev += [_dev("k210.serve.net", 20, 30, annotation=True),
                _dev("k210.serve.batch", 5, 66, annotation=True)]
    return host + dev


def _summary(events):
    prof = SimpleNamespace(prof=SimpleNamespace(events=lambda: events),
                           t0=0.0, t1=140e-6)
    return TR.summarize(prof, 1, 8)


def test_program_spans_attribute_launches_and_idle():
    got = TR.program_spans(_events())
    assert set(got) == {"serve.batch", "serve.h2d", "serve.net",
                        "serve.head", "serve.d2h", "train.backward"}
    us = 1e-6
    # nesting: the call holds its stages, so its device time is theirs
    assert got["serve.batch"]["count"] == 1
    assert got["serve.batch"]["host_s"] == pytest.approx(100 * us)
    assert got["serve.batch"]["self_s"] == pytest.approx(30 * us)
    assert got["serve.batch"]["device_s"] == pytest.approx(15 * us)
    assert got["serve.batch"]["copies_s"] == pytest.approx(14 * us)
    assert got["serve.batch"]["launches"] == 2
    assert got["serve.net"]["device_s"] == pytest.approx(10 * us)
    assert got["serve.head"]["device_s"] == pytest.approx(5 * us)
    assert got["serve.h2d"]["copies_s"] == pytest.approx(10 * us)
    assert got["serve.h2d"]["device_s"] == 0.0
    # autograd's thread has no span: its launch at 110 belongs to the
    # calling thread's span that holds it
    assert got["train.backward"]["device_s"] == pytest.approx(20 * us)
    assert got["train.backward"]["launches"] == 1
    # idle gaps [-1, 5], [15, 20], [30, 45], [50, 62], [66, 115], [135,
    # 140], split at span boundaries: [-1, 0] is in no program span;
    # [30, 45] is 10 in net, 5 in head; [66, 115] is 4 in d2h, 30 in the
    # call's own time, 15 in backward
    assert got["serve.h2d"]["idle_s"] == pytest.approx(5 * us)
    assert got["serve.net"]["idle_s"] == pytest.approx(15 * us)
    assert got["serve.head"]["idle_s"] == pytest.approx(15 * us)
    assert got["serve.d2h"]["idle_s"] == pytest.approx(6 * us)
    assert got["serve.batch"]["idle_s"] == pytest.approx(30 * us)
    assert got["train.backward"]["idle_s"] == pytest.approx(20 * us)
    total_idle = 5 + 5 + 15 + 12 + 49 + 5
    assert sum(r["idle_s"] for r in got.values()) == pytest.approx(
        total_idle * us)


def test_touching_siblings_do_not_nest():
    """A stage that starts in the microsecond its sibling ends is that
    sibling's sibling, not its child."""
    host = [_host("k210.serve.batch", 0, 20), _host("k210.serve.d2h", 0, 10),
            _host("k210.serve.detections", 10, 20),
            _host("aten::x", 15, 16, kernels=[("k", 1.0)])]
    got = TR.program_spans(host + [_dev("k", 1, 2)])
    assert got["serve.d2h"]["self_s"] == pytest.approx(10e-6)
    assert got["serve.d2h"]["device_s"] == 0.0
    assert got["serve.detections"]["device_s"] == pytest.approx(1e-6)
    assert got["serve.batch"]["self_s"] == 0.0


@pytest.mark.parametrize("name", ["cudaFuncSetAttribute",
                                  "cudaStreamIsCapturing", "cuLaunchKernelEx",
                                  "Activity Buffer Request", "Buffer Flush"])
def test_bookkeeping_events_launch_nothing(name):
    """A runtime call or the profiler's overhead that the profiler handed
    another op's kernels (ids from two spaces that met) adds nothing to
    any span; the op itself still counts."""
    host = [_host("k210.serve.head", 0, 20),
            _host("aten::flatten", 2, 3, kernels=[("flat_kernel", 1.0)]),
            _host(name, 5, 6, kernels=[("other_kernel", 64.0),
                                       ("Memcpy DtoD", 1.0)]),
            _host(name, 8, 9, thread=AUTOGRAD,
                  kernels=[("other_kernel", 64.0)])]
    got = TR.program_spans(host + [_dev("flat_kernel", 3, 4)])
    assert got["serve.head"]["device_s"] == pytest.approx(1e-6)
    assert got["serve.head"]["launches"] == 1
    assert got["serve.head"]["copies_s"] == 0.0
    assert not TR._bookkeeping(SimpleNamespace(name="aten::cumsum"))
    assert not TR._bookkeeping(SimpleNamespace(name="custom_op"))


def test_no_program_spans_give_an_empty_table():
    assert TR.program_spans(_events(program=False)) == {}


def test_the_summary_is_the_same_with_the_program_spans():
    """The device's copies of the ranges count as no device time.  The idle
    gaps are the same gaps, named now after the innermost host event under
    way, which a program span can be.  ``program`` is empty without the
    program's spans and ``program_spans``' table with them."""
    events = _events(program=True)
    with_spans = _summary(events)
    without = _summary(_events(program=False))
    gaps_with, gaps_without = (with_spans.pop("idle_gaps"),
                               without.pop("idle_gaps"))
    assert without.pop("program") == {}
    program = with_spans.pop("program")
    assert program == TR.program_spans(events)
    for rec in program.values():
        assert {"count", "device_s", "launches", "copies_s",
                "idle_s"} <= set(rec)
    assert program["serve.net"]["launches"] == 1
    assert with_spans == without
    assert sum(gaps_with.values()) == pytest.approx(
        sum(gaps_without.values()))
    assert max(gaps_without, key=gaps_without.get) == "yb.call"
    assert max(gaps_with, key=gaps_with.get).startswith(TR.PROGRAM_PREFIX)


# ``summarize`` of ``_events()`` before it held ``program``
_SPANS = {"call": {"copies_s": 1.4000000000000001e-05,
                   "device_s": 1.5000000000000002e-05, "launches": 2,
                   "ops": {"Memcpy DtoH": 4e-06, "Memcpy HtoD": 1e-05,
                           "conv_kernel": 1e-05, "flat_kernel": 5e-06}}}
_BEFORE = {"busy_s": 4.9e-05, "calls": 1,
           "copies_s": 1.4000000000000001e-05,
           "device_ops": {"Memcpy DtoH": 4e-06, "Memcpy HtoD": 1e-05,
                          "bwd_kernel": 2e-05, "conv_kernel": 1e-05,
                          "flat_kernel": 5e-06},
           "images": 8, "launches": 3, "spans": _SPANS, "window_s": 0.00014}


@pytest.mark.parametrize("program", [True, False], ids=["k210", "none"])
def test_the_summary_keeps_its_keys_as_they_were(program):
    got = _summary(_events(program=program))
    got.pop("program")
    assert got == dict(_BEFORE, idle_gaps=(
        {"k210.serve.batch": 4.9e-05, "k210.serve.head": 1.2e-05,
         "k210.serve.net": 2e-05} if program else {"yb.call": 8.1e-05}))


def test_per_call_is_ms_a_call():
    program = {"serve.net": {"count": 4, "host_s": 2e-3, "self_s": 1e-3,
                             "device_s": 8e-3, "launches": 40,
                             "copies_s": 0.0, "idle_s": 1e-3}}
    summary = {"calls": 2, "window_s": 0.010, "busy_s": 0.008}
    got = P.per_call(program, summary)
    assert got["busy_ms"] == pytest.approx(4.0)
    assert got["idle_ms"] == pytest.approx(1.0)
    assert got["idle_in_span"] == pytest.approx(0.5)
    assert got["spans"]["serve.net"] == pytest.approx(
        {"count": 4, "host_ms": 1.0, "self_ms": 0.5, "device_ms": 4.0,
         "launches": 40, "copies_ms": 0.0, "idle_ms": 0.5})


# the program's stages a call, by the entry kind that drives the cell
SPANS = {"serve_batch": ["serve.batch", "serve.h2d", "serve.letterbox",
                         "serve.net", "serve.head", "serve.d2h",
                         "serve.detections"],
         "train_step": ["train.step", "train.preprocess", "train.forward",
                        "train.loss", "train.backward", "train.optimizer",
                        "train.metrics", "preprocess.letterbox",
                        "preprocess.augment", "preprocess.normalize",
                        "preprocess.encode"]}


@pytest.mark.parametrize("name", sorted(_small.SMALL))
def test_small_cell_traced_has_its_spans_once_a_call(name):
    cell = _small.cell(name)
    line, table = P.traced(cell, 5, 0.3, torch.device("cpu"))
    assert line["correct"] is True, line["check"]
    calls = table["calls"]
    assert calls == _small.SMALL[name]["traffic"]["trace_calls"]
    for stage in SPANS[cell.traffic["entry"]]:
        assert table["spans"][stage]["count"] == calls, stage

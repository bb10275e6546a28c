"""Each cell's control, at a size a test run holds, comes out not correct
against the cell's limits: the program's own int8 path for the serving
cells, the reference in fp8 in the program's place for training
(``readings.CONTROL``).  The chip readings at the cells' own sizes, from
``python -m yolo_bench.readings``, are in ``PERF.md``."""

import pytest

from yolo_bench import readings
from yolo_bench.tests import _small

SIZES = {"v1-serve-b128": {"traffic": {"batch": 32, "pool": 1},
                           "check": {"sample": 1}},
         "yolov3-608-eval-b32": {"traffic": {"batch": 4, "pool": 1},
                                 "check": {"sample": 1, "ref_block": 4}},
         "v1-train-b128": {"traffic": {"batch": 32, "pool": 3}}}


@pytest.mark.parametrize("name", sorted(SIZES))
def test_the_control_is_not_correct(name):
    entry = _small.cell(name).traffic["entry"]
    over = {k: dict(v) for k, v in SIZES[name].items()}
    for k, v in readings.CONTROL[entry].items():
        over.setdefault(k, {}).update(v)
    line = _small.run(name, seed=4, seconds=0.0, **over)
    assert line["correct"] is False, line["check"]

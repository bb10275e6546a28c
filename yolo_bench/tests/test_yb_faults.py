"""The harness, its look for a chip skipped, drives a run with the
program broken underneath, and ``correct`` comes out false: once for each
fault the cell can have (``yolo_bench/faults.py``, by the entry kind that
drives it), in every cell with a small cut.  The limits are the cells'
own."""

import pytest

from yolo_bench import faults
from yolo_bench.tests import _small

CASES = [(name, fault) for name in sorted(_small.SMALL)
         for fault in faults.FOR_ENTRY[_small.cell(name).traffic["entry"]]]


@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{n}-{f}" for n, f in CASES])
def test_a_planted_fault_is_not_correct(name, fault):
    assert _small.run(name, seed=9)["correct"] is True
    undo = faults.FAULTS[fault]()
    try:
        line = _small.run(name, seed=9)
    finally:
        undo()
    assert line["correct"] is False, line["check"]

"""The harness, its look for a chip skipped, drives a run with the
program broken underneath, and ``correct`` comes out false: once for each
fault the cell can have (``yolo_bench/faults.py``).  The limits are the
cells' own."""

import pytest

from yolo_bench import faults
from yolo_bench.tests import _small

CASES = [("v1-train-b128", "half_batch"), ("v1-train-b128",
                                           "state_unchanged"),
         ("v1-serve-b128", "answers_altered"),
         ("v1-serve-b128", "half_answers"),
         ("yolov3-608-eval-b32", "answers_altered"),
         ("yolov3-608-eval-b32", "half_answers")]


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

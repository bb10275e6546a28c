"""Each cell's control, at a size a test run holds, comes out not correct
against the cell's limits: the program's own int8 path for the serving
cells, the reference in fp8 in the program's place for training
(``readings.CONTROL``), at the size ``tests/control/<cell>.json`` gives.
The chip readings at the cells' own sizes, from
``python -m yolo_bench.readings``, are in ``PERF.md``."""

import pytest

from yolo_bench import readings
from yolo_bench import run as R
from yolo_bench.tests import _small


def test_every_cell_has_a_cpu_cut_and_a_control_size():
    """A cell of ``BENCHMARK.json`` without ``tests/small/<cell>.json`` or
    ``tests/control/<cell>.json`` would go untested without a word."""
    cells = {w["name"] for w in R.load_json(R.ROOT / "BENCHMARK.json")
             ["workloads"]}
    assert set(_small.SMALL) == cells
    assert set(_small.CONTROL_SIZES) == cells


@pytest.mark.parametrize("name", sorted(_small.SMALL))
def test_the_control_is_not_correct(name):
    assert name in _small.CONTROL_SIZES, f"no tests/control/{name}.json"
    entry = _small.cell(name).traffic["entry"]
    over = {k: dict(v) for k, v in _small.CONTROL_SIZES[name].items()}
    for k, v in readings.CONTROL[entry].items():
        over.setdefault(k, {}).update(v)
    line = _small.run(name, seed=4, seconds=0.0, **over)
    assert line["correct"] is False, line["check"]

"""On the card: each cell through the command itself, briefly, traced and
not, comes out correct.  Skips where no CUDA card is (decided in the
test)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from yolo_bench import run as R

ROOT = Path(R.__file__).resolve().parent.parent
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", ["0", "1"])
def test_cell_on_the_card(name, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "-m", "yolo_bench.run", "--workload", name,
         "--seed", "2147483659", "--seconds", "2", "--trace", trace],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["check"]
    assert line["device"]["platform"] == "gpu"

"""No run loads JAX, flax or the JAX package, and the reference loads
nothing of the port: top-level module names compared whole (the port's
name begins with the JAX package's)."""

import subprocess
import sys
from pathlib import Path

from yolo_bench import run as R

ROOT = Path(R.__file__).resolve().parent.parent


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.', 1)[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return set(out.stdout.split())


def test_the_reference_loads_nothing_of_the_port():
    tops = _modules_after(
        "import yolo_bench.reference.nets, yolo_bench.reference.serve, "
        "yolo_bench.reference.train")
    assert "k210_yolo_framework_tpu_torch" not in tops
    assert not tops & set(R.FORBIDDEN)


def test_a_run_loads_nothing_forbidden():
    tops = _modules_after(
        "from yolo_bench.tests import _small\n"
        "for n in _small.SMALL: _small.run(n)")
    assert "k210_yolo_framework_tpu_torch" in tops     # the port ran
    assert not tops & set(R.FORBIDDEN)


def test_the_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "k210_yolo_framework_tpu_torch_x",
                        sys)
    assert R.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert R.forbidden_loaded() == ["jaxlib"]

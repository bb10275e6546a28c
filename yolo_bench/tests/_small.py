"""The cells cut to a size the CPU runs in seconds, for the tests: the
same files, smaller batches and pools, and YOLOv3 at 224x224.  A cell's
cut is ``small/<cell>.json`` (overrides of its ``config``, ``traffic`` and
``check``, as ``run.Cell`` takes them); a cell with such a file is under
the tests that run every small cell.  ``control/<cell>.json`` is the size
at which its control runs (``test_yb_control.py``)."""

import json
from pathlib import Path

import torch

from yolo_bench import run as R

HERE = Path(__file__).resolve().parent


def _cuts(folder: str) -> dict:
    return {p.name[:-len(".json")]: json.loads(p.read_text())
            for p in sorted((HERE / folder).glob("*.json"))}


SMALL = _cuts("small")
CONTROL_SIZES = _cuts("control")


def cell(name: str, **more) -> R.Cell:
    over = {k: dict(v) for k, v in SMALL[name].items()}
    for k, v in more.items():
        over.setdefault(k, {}).update(v)
    return R.Cell(name, overrides=over)


def run(name: str, seed: int = 5, trace: bool = False, seconds=0.3,
        **more) -> dict:
    return R.run(cell(name, **more), seed, seconds, trace,
                 torch.device("cpu"))

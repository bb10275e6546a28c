"""The cells cut to a size the CPU runs in seconds, for the tests: the
same files, smaller batches and pools, and YOLOv3 at 224x224."""

import torch

from yolo_bench import run as R

SMALL = {
    "v1-serve-b128": {"traffic": {"batch": 8, "pool": 2, "trace_start": 1,
                                  "trace_calls": 2},
                      "check": {"sample": 2}},
    "yolov3-608-eval-b32": {
        "config": {"in_hw": [224, 224], "out_hws": [[7, 7], [14, 14],
                                                    [28, 28]]},
        "traffic": {"batch": 2, "pool": 2, "trace_start": 1,
                    "trace_calls": 2},
        "check": {"sample": 2, "ref_block": 2}},
    "v1-train-b128": {"traffic": {"batch": 6, "pool": 4, "trace_start": 3,
                                  "trace_calls": 2}},
}


def cell(name: str, **more) -> R.Cell:
    over = {k: dict(v) for k, v in SMALL[name].items()}
    for k, v in more.items():
        over.setdefault(k, {}).update(v)
    return R.Cell(name, overrides=over)


def run(name: str, seed: int = 5, trace: bool = False, seconds=0.3,
        **more) -> dict:
    return R.run(cell(name, **more), seed, seconds, trace,
                 torch.device("cpu"))

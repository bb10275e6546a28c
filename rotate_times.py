#!/usr/bin/env python3
"""Time the rotation kernel of one checkout of the port on one NVIDIA GPU:
``csrc/rotate3shear.cu`` through ``ops/rotate_pallas._launch`` at the train
path's shape (42 images of 224x320x3, ``chip_smoke.py``'s phase 9 inputs),
in bf16 and fp32, each by CUDA events around 20 back-to-back launches and
on the card alone, the 20 launches queued behind a spin kernel
(``chip_smoke.device_ms``).

    python3 rotate_times.py [--root DIR] [--label NAME]

``--root`` names the checkout whose package is timed (default: the one
beside this script).  The timers come from the ``chip_smoke.py`` beside
this script, so two versions of the kernel, each timed from its own
checkout, are measured alike: run them in one call, in the order parent,
change, change, parent.  Prints the card's name and power limit, then one
JSON line of times in ms.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROT_N, HW = 42, (224, 320)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose k210_yolo_framework_tpu_torch is "
                         "timed")
    ap.add_argument("--label", default="", help="name printed with the times")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec_ = importlib.util.spec_from_file_location("chip_smoke_timers",
                                                   HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(cs)

    import torch

    if not torch.cuda.is_available():
        print("rotate_times: no CUDA device", file=sys.stderr)
        return 1
    import k210_yolo_framework_tpu_torch as pkg
    from k210_yolo_framework_tpu_torch.ops import rotate_pallas as TR

    if Path(pkg.__file__).resolve().parent.parent != root:
        raise AssertionError(f"imported {pkg.__file__}, not from {root}")
    device = torch.device("cuda")
    print(cs.gpu_label())
    out = {"label": args.label}
    rng = np.random.default_rng(4)
    for dtype in (torch.bfloat16, torch.float32):
        imgs = torch.from_numpy(rng.integers(0, 256, (ROT_N, *HW, 3)).astype(
            np.float32)).to(device).to(dtype)
        tables = TR.shear_tables(torch.from_numpy(np.deg2rad(
            rng.uniform(-10, 10, ROT_N)).astype(np.float32)).to(device),
            *HW, dtype)
        kern = lambda: TR._launch(imgs, tables)  # noqa: E731
        if not torch.equal(kern(), TR._rotate_plain(imgs, tables)):
            raise AssertionError("the kernel is not the plain result")
        k1 = cs.time_ms(kern, 20)
        dev = cs.device_ms(kern, 20)
        k2 = cs.time_ms(kern, 20)
        out[str(dtype).split(".")[-1]] = {"events_ms": [k1, k2],
                                          "device_ms": dev}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

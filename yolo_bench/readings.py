"""The readings a cell's limits are set from, on the chip at the cell's own
size, in one process:

    python -m yolo_bench.readings --workload <cell> --seeds 1,2,...
        [--control-seeds 7,8,9] [--seconds 3] [--out <file.jsonl>]

For each of ``--seeds`` a short run of the program as the cell states it,
then for each of ``--control-seeds`` the control: serving cells run the
program's own int8 path (``Predictor(quantize="int8_act")``), training
cells the reference in fp8 in the program's place; then for each of
``--fault-seeds`` the program with ``--fault`` planted
(``yolo_bench/faults.py``).  Each run's compared
numbers go to standard output (and ``--out``) as one JSON line.  The
benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence

from yolo_bench import faults
from yolo_bench import run as R

CONTROL = {"serve_batch": {"config": {"serve_quantize": "int8_act"}},
           "train_step": {"config": {"train_as": "reference_fp8"}}}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m yolo_bench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default=None,
                    help="a fault of yolo_bench.faults, planted in the "
                         "program for --fault-seeds")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    R._fixed_caches()
    import torch

    device = R.device_of(torch, "cuda")
    out = open(args.out, "a") if args.out else None
    plan = [("program", int(s)) for s in args.seeds.split(",") if s]
    plan += [("control", int(s)) for s in args.control_seeds.split(",") if s]
    plan += [(f"fault:{args.fault}", int(s))
             for s in args.fault_seeds.split(",") if s]
    for variant, seed in plan:
        cell = R.Cell(args.workload)
        if variant == "control":
            cell = R.Cell(args.workload,
                          overrides=CONTROL[cell.traffic["entry"]])
        undo = (faults.FAULTS[args.fault]() if variant.startswith("fault")
                else None)
        t0 = time.perf_counter()
        try:
            line = R.run(cell, seed, args.seconds, False, device)
        finally:
            if undo is not None:
                undo()
        rec = {"workload": args.workload, "variant": variant, "seed": seed,
               "check": line["check"], "detail": line["detail"], "correct": line["correct"],
               "attempted": line["attempted"],
               "seconds": time.perf_counter() - t0}
        print(json.dumps(rec), flush=True)
        if out:
            out.write(json.dumps(rec) + "\n")
            out.flush()
        del line
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The program's own spans in a traced run: which stage of the serving entry
or the train step launched each device event, and inside which stage the
device sat idle.

    python -m yolo_bench.program --workload <cell> --seed <n> [--seconds 5]

runs the cell traced, as ``python -m yolo_bench.run --trace 1`` does, prints
that run's result line and then one JSON line of the traced stretch's
program spans (``trace.program_spans``, the summary's ``program``) in ms a
call (a step), with the share of the device's idle time that fell inside
some program span.  The benchmark's own runs do not run this; their metric
readers read the same spans under the summary's ``program``.

The port names its spans ``k210.<stage>`` (its ``utils/trace.span``),
entered only while a profiler records; a commit of the port without them
gives an empty table.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional, Sequence

from yolo_bench import run as R
from yolo_bench import trace as TR


def per_call(program: Dict[str, dict], summary: dict) -> dict:
    """``program`` a call: the seconds as ms (``host_ms``, ...), ``count``
    and ``launches`` as they are; with the device's busy and idle ms a
    call over the stretch and the share of the idle inside some span."""
    calls = summary["calls"]
    idle_s = summary["window_s"] - summary["busy_s"]
    spans = {name: {(k if k in ("count", "launches") else k[:-2] + "_ms"):
                    (v if k in ("count", "launches") else v / calls * 1e3)
                    for k, v in r.items()}
             for name, r in sorted(program.items())}
    inside = sum(r["idle_s"] for r in program.values())
    return {"calls": calls, "busy_ms": summary["busy_s"] / calls * 1e3,
            "idle_ms": idle_s / calls * 1e3,
            "idle_in_span": inside / idle_s if idle_s > 0 else None,
            "spans": spans}


def traced(cell: R.Cell, seed: int, seconds: float, device) -> tuple:
    """``run.run`` of the cell traced; its line and :func:`per_call` of
    the traced stretch's program spans."""
    seen = {}
    summarize = TR.summarize

    def keep(prof, calls, images):
        seen["summary"] = summarize(prof, calls, images)
        return seen["summary"]

    TR.summarize = keep
    try:
        line = R.run(cell, seed, seconds, True, device)
    finally:
        TR.summarize = summarize
    return line, per_call(seen["summary"]["program"], seen["summary"])


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m yolo_bench.program")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    R._fixed_caches()
    cell = R.Cell(args.workload)
    import torch

    torch.set_num_threads(1)
    device = R.device_of(torch, "cuda", int(cell.entry["chips"]))
    line, table = traced(cell, args.seed, args.seconds, device)
    line.pop("detail")
    print(json.dumps(line), flush=True)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      **table}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

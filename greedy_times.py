#!/usr/bin/env python3
"""Time the greedy kernels of one checkout of the port on one NVIDIA GPU:
the fused head (``csrc/yolo_head.cu``) and NMS alone (``csrc/nms.cu``), on
the inputs of ``chip_smoke.py``'s phases 5 and 14, each by CUDA events
around 20 back-to-back calls and on the card alone, the 20 launches queued
ahead behind a spin kernel (``chip_smoke.device_ms``).

    python3 greedy_times.py [--root DIR] [--label NAME]

``--root`` names the checkout whose package is timed (default: the one
beside this script).  The inputs and the timers come from the
``chip_smoke.py`` beside this script, so two versions of the kernels,
each timed from its own checkout, are measured alike: run them in one
call, in the order parent, change, change, parent.  Prints the card's
name and power limit, then one JSON line of times in ms.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def times(cs, kern) -> dict:
    """Events (twice) around the card-alone time of the same launches."""
    k1 = cs.time_ms(kern, 20)
    dev = cs.device_ms(kern, 20)
    k2 = cs.time_ms(kern, 20)
    return {"events_ms": [k1, k2], "device_ms": dev}


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
        print("greedy_times: no CUDA device", file=sys.stderr)
        return 1
    import k210_yolo_framework_tpu_torch as pkg
    from k210_yolo_framework_tpu_torch import voc_spec
    from k210_yolo_framework_tpu_torch.ops import decode as TD
    from k210_yolo_framework_tpu_torch.ops import nms_pallas as TN
    from k210_yolo_framework_tpu_torch.ops import yolo_head_pallas as TH

    if Path(pkg.__file__).resolve().parent.parent != root:
        raise AssertionError(f"imported {pkg.__file__}, not from {root}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    print(cs.gpu_label())
    spec = voc_spec()
    _, scenes, canvases, hws, _ = cs.serving_scenes(spec, device)
    c_dev = torch.from_numpy(canvases).to(device)
    h_dev = torch.from_numpy(hws).to(device)
    with torch.inference_mode():
        scene_preds = {name: p._forward_batch(c_dev, h_dev)
                       for name, p in scenes}
    synth = {name: (preds, hws_) for name, _, preds, hws_ in
             cs.head_cases(spec, cs.three_scale_spec(), device)}
    slice_preds = scene_preds["sparse"]
    ev = cs.EVAL
    head = {   # name: (logits, img_hws, threshold, max_out, iou), phase 5's
        "slice": (slice_preds, h_dev, 0.7, 30, cs.IOU),
        "sparse": (*synth["sparse"], 0.7, 30, cs.IOU),
        "dense": (*synth["dense"], 0.7, 30, cs.IOU),
        "eval": ([t[:cs.EVAL_BATCH] for t in slice_preds],
                 h_dev[:cs.EVAL_BATCH], ev["obj_thresh"], ev["max_out"],
                 ev["iou_thresh"]),
    }
    out = {"label": args.label, "head": {}, "nms": {}}
    for name, (preds, hws_, thresh, max_out, iou) in head.items():
        p = TH._flatten_preds(preds, spec.class_num)
        geom = TH._geometry_on(spec, device)
        lbox = TH.letterbox_inverse_params(hws_, spec.in_hw).contiguous()
        out["head"][name] = times(cs, lambda: TH._launch(
            p, geom, lbox, classes=spec.class_num, max_out=max_out,
            iou_thresh=iou, score_thresh=thresh, class_softmax=False))
    for name, pr in scenes:     # phase 14's
        boxes, scores = TD.decode_outputs(scene_preds[name], spec, h_dev)
        out["nms"][name] = times(cs, lambda: TN._launch(
            boxes, scores, max_out=30, iou_thresh=cs.IOU,
            score_thresh=pr.obj_thresh))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

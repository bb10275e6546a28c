"""VOC mAP of a checkpoint over a data set: the flags of the JAX package's
root ``keras_eval.py``, plus ``--device``.

    python -m k210_yolo_framework_tpu_torch.cli.keras_eval \
        log/<run>/yolo_model.npz --train_set voc \
        --model_def yolo_mobilev1 --depth_multiplier 0.75

Scores ``data/<set>_img_ann.npy`` in batches of ``--batch_size`` through
``Predictor.predict_batch`` (one fused head launch a batch on a CUDA
device), prints each class's AP and the mAP, and with ``--coco`` also
mAP@[.5:.95].  ``--quantize`` takes the ``Predictor`` modes;
``int8_act_cal`` calibrates on ``--calib_size`` rows of ``--calib_list``
(or, without it, on the last rows of the set, held out of the eval).
"""

import argparse
import sys
import time

import numpy as np


def main(args) -> dict:
    """Score the set, print the table, return ``match_detections``'s
    result with ``imgs_per_s`` (detection only, host staging included)."""
    import torch

    from k210_yolo_framework_tpu_torch.cli import str2bool
    from k210_yolo_framework_tpu_torch.config import YoloSpec
    from k210_yolo_framework_tpu_torch.data.annotations import load_ann_list
    from k210_yolo_framework_tpu_torch.eval import (
        calibrate_from_rows,
        collect_detections,
        match_detections,
        match_detections_sweep,
        split_calibration_rows,
    )
    from k210_yolo_framework_tpu_torch.inference import Predictor, VOC_LABELS
    from k210_yolo_framework_tpu_torch.models import build_network
    from k210_yolo_framework_tpu_torch.training import checkpoint as CK
    from k210_yolo_framework_tpu_torch.training.train import checked_device
    from k210_yolo_framework_tpu_torch.utils import INFO, NOTE, quantize_mode

    mode = quantize_mode(args.quantize)
    device = checked_device(args.device)
    spec = YoloSpec.from_files(
        f"data/{args.train_set}_anchor.npy",
        in_hw=tuple(args.image_size),
        out_hws=tuple(args.output_size),
        class_num=args.class_num)

    net = build_network(args.model_def, spec.in_hw, spec.nanchors,
                        spec.class_num, alpha=args.depth_multiplier)
    state = CK.load_variables(args.pre_ckpt, args.model_def, net)
    print(INFO, f"Load CKPT {args.pre_ckpt}")

    pred = Predictor(net, state, spec, obj_thresh=args.obj_thresh,
                     iou_thresh=args.iou_thresh, max_out=args.max_out,
                     compute_dtype=(torch.bfloat16 if str2bool(args.bf16)
                                    else torch.float32),
                     quantize=mode, device=device)
    ann = load_ann_list(f"data/{args.train_set}_img_ann.npy")
    if mode == "int8_act_cal":
        # calibration rows disjoint from the eval rows: calibrating on the
        # eval set would leak it into the quantization ranges
        calib = load_ann_list(args.calib_list) if args.calib_list else None
        ann, calib_rows = split_calibration_rows(ann, calib, args.calib_size)
        src = args.calib_list or f"last {len(calib_rows)} rows (held out)"
        print(NOTE, f"int8_act_cal: calibrating on {len(calib_rows)} rows "
                    f"from {src}")
        if not args.calib_list:
            print(NOTE, f"eval set is {len(ann)} rows after the holdout "
                        "(other quantize modes eval the full list; use "
                        "--calib_list to keep eval sets identical)")
        calibrate_from_rows(pred, calib_rows)
    if args.limit:
        ann = ann[:args.limit]
    print(INFO, f"evaluating {len(ann)} rows")

    t0 = time.perf_counter()
    record = collect_detections(
        pred, ann, args.class_num, batch_size=args.batch_size,
        progress=lambda d, t: print(f"\r eval {d}/{t}", end=""))
    rate = len(ann) / max(time.perf_counter() - t0, 1e-9)
    print()
    res = match_detections(record, args.map_iou, not args.use_12_metric)
    if args.coco:
        sweep = match_detections_sweep(record)
        print(NOTE, f"mAP@[.5:.95] = {sweep['map']:.4f}  "
              + " ".join(f"{k}:{v:.3f}"
                         for k, v in sweep["map_per_iou"].items()))
    labels = VOC_LABELS if args.class_num == len(VOC_LABELS) else [
        str(i) for i in range(args.class_num)]
    for c, ap in enumerate(res["ap"]):
        if not np.isnan(ap):
            print(f"  {labels[c]:<16s} AP@{args.map_iou:.2f} = {ap:.4f}")
    print(NOTE, f"mAP@{args.map_iou:.2f} = {res['map']:.4f}")
    print(INFO, f"{rate:.1f} imgs/s over {len(ann)} images on {device}")
    return {**res, "imgs_per_s": rate}


def parse_args(argv):
    parser = argparse.ArgumentParser()
    parser.add_argument("pre_ckpt", type=str)
    parser.add_argument("--train_set", type=str, default="voc")
    parser.add_argument("--class_num", type=int, default=20)
    parser.add_argument("--model_def", type=str, default="yolo_mobilev2")
    parser.add_argument("--depth_multiplier", type=float,
                        choices=[0.5, 0.75, 1.0], default=1.0)
    parser.add_argument("--image_size", type=int, default=(224, 320),
                        nargs="+")
    parser.add_argument("--output_size", type=int, default=(7, 10, 14, 20),
                        nargs="+")
    parser.add_argument("--obj_thresh", type=float, default=0.01,
                        help="low for mAP: AP integrates the whole PR curve")
    parser.add_argument("--iou_thresh", type=float, default=0.45)
    parser.add_argument("--map_iou", type=float, default=0.5)
    parser.add_argument("--max_out", type=int, default=100)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--use_12_metric", action="store_true",
                        help="all-points AP instead of VOC07 11-point")
    parser.add_argument("--coco", action="store_true",
                        help="also report COCO-style mAP@[.5:.95]")
    parser.add_argument("--bf16", type=str, default="False",
                        help="bf16 conv compute (default fp32)")
    parser.add_argument("--quantize", type=str, default="False",
                        help="True/int8, int8_act, int8_act_sym, "
                             "int8_act_cal or False")
    parser.add_argument("--limit", type=int, default=0)
    parser.add_argument("--calib_list", type=str, default=None,
                        help="int8_act_cal: an ann-list .npy disjoint from "
                             "the eval set (e.g. the train split); default: "
                             "hold out the last --calib_size eval rows")
    parser.add_argument("--calib_size", type=int, default=32)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' where there is no card")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args(sys.argv[1:]))

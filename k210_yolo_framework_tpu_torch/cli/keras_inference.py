"""Detect objects in one image: the flags of the JAX package's root
``keras_inference.py``, plus ``--device``.

    python -m k210_yolo_framework_tpu_torch.cli.keras_inference \
        log/<run>/yolo_model.npz dog.jpg --train_set voc \
        --model_def yolo_mobilev1 --depth_multiplier 0.75

Loads the weights with ``training.checkpoint.load_variables``, serves the
image with ``Predictor.predict_image`` (on a CUDA device the fused
decode+NMS head runs as its CUDA kernel), prints the boxes as the
``[top left bottom right score class]`` table and saves the drawn image
(``--output``, default ``<image>_det.png``).  ``--quantize`` takes the
``Predictor`` modes (``utils.quantize_mode``); ``int8_act_cal`` calibrates
on the input image itself.
"""

import argparse
import sys
from pathlib import Path

import numpy as np


def main(args):
    """Serve the image, print and draw the detections, return them."""
    import torch

    from k210_yolo_framework_tpu_torch.cli import str2bool
    from k210_yolo_framework_tpu_torch.config import YoloSpec
    from k210_yolo_framework_tpu_torch.data.annotations import read_image
    from k210_yolo_framework_tpu_torch.inference import (
        Predictor,
        draw_detections,
    )
    from k210_yolo_framework_tpu_torch.models import build_network
    from k210_yolo_framework_tpu_torch.training import checkpoint as CK
    from k210_yolo_framework_tpu_torch.training.train import checked_device
    from k210_yolo_framework_tpu_torch.utils import INFO, NOTE, quantize_mode

    device = checked_device(args.device)
    spec = YoloSpec.from_files(
        f"data/{args.train_set}_anchor.npy",
        in_hw=tuple(args.image_size),
        out_hws=tuple(args.output_size),
        class_num=args.class_num)

    net = build_network(args.model_def, spec.in_hw, spec.nanchors,
                        spec.class_num, alpha=args.depth_multiplier)
    state = CK.load_variables(args.pre_ckpt, args.model_def, net)
    print(INFO, f" Load CKPT {args.pre_ckpt}")

    pred = Predictor(net, state, spec, obj_thresh=args.obj_thresh,
                     iou_thresh=args.iou_thresh,
                     compute_dtype=(torch.bfloat16 if str2bool(args.bf16)
                                    else None),
                     quantize=quantize_mode(args.quantize), device=device)
    img = read_image(args.test_image)
    if pred.quantize == "int8_act_cal":
        # one image: calibrate on the input itself (a one-image
        # representative set)
        pred.calibrate(img[None], np.asarray([img.shape[:2]], np.int32))
    det = pred.predict_image(img)

    if len(det.classes) > 0:
        print("[top\tleft\tbottom\tright\tscore\tclass]")
        for box, score, c in zip(det.boxes, det.scores, det.classes):
            top, left, bottom, right = box
            print(f"[{top:.1f}\t{left:.1f}\t{bottom:.1f}\t{right:.1f}\t"
                  f"{score:.2f}\t{int(c):2d}]")
        from PIL import Image

        out_path = args.output or (str(Path(args.test_image).with_suffix(""))
                                   + "_det.png")
        Image.fromarray(draw_detections(img, det)).save(out_path)
        print(INFO, f" Saved result to {out_path}")
    else:
        print(NOTE, " no boxes detected")
    return det


def parse_args(argv):
    parser = argparse.ArgumentParser()
    parser.add_argument("--train_set", type=str, default="voc")
    parser.add_argument("--class_num", type=int, default=20)
    parser.add_argument("--model_def", type=str, default="yolo_mobilev2")
    parser.add_argument("--depth_multiplier", type=float,
                        choices=[0.5, 0.75, 1.0], default=1.0)
    parser.add_argument("--image_size", type=int, default=(224, 320),
                        nargs="+")
    parser.add_argument("--output_size", type=int, default=(7, 10, 14, 20),
                        nargs="+")
    parser.add_argument("--obj_thresh", type=float, default=0.7)
    parser.add_argument("--iou_thresh", type=float, default=0.3)
    parser.add_argument("--output", type=str, default=None,
                        help="output image path")
    parser.add_argument("--bf16", type=str, default="False",
                        help="bf16 conv compute (default fp32)")
    parser.add_argument("--quantize", type=str, default="False",
                        help="True/int8 (int8 weights), int8_act, "
                             "int8_act_sym, int8_act_cal (int8 conv "
                             "compute; _cal calibrates on the image) or "
                             "False")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' where there is no card")
    parser.add_argument("pre_ckpt", type=str)
    parser.add_argument("test_image", type=str)
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args(sys.argv[1:]))

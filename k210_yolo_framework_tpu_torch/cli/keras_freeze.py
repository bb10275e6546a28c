"""Freeze a checkpoint into export artifacts: the flags of the JAX
package's root ``keras_freeze.py``, plus ``--device``.

    python -m k210_yolo_framework_tpu_torch.cli.keras_freeze \
        log/<run>/yolo_model.npz --train_set voc \
        --model_def yolo_mobilev1 --depth_multiplier 0.75

Loads the weights with ``training.checkpoint.load_variables`` and writes
``export.freeze``'s artifacts into ``--out_dir`` (default
``<checkpoint dir>/Freeze_save``): ``yolo_model.pt2`` and
``yolo_serving.pt2`` (``torch.export`` programs, traced on ``--device``),
``yolo_model.npz``, and where h5py imports ``yolo_model.h5`` and (with
``--reference_h5 True``) ``yolo_model_reference.h5``.  TFLite needs
TensorFlow, which the port does not use: ``--tflite``,
``--tflite_int8`` and ``--tflite_dataset`` each print a NOTE instead.
Prints the input and output node lines.
"""

import argparse
import sys
from pathlib import Path


def main(args):
    """Write the artifacts; returns {artifact: path}."""
    from k210_yolo_framework_tpu_torch.cli import str2bool
    from k210_yolo_framework_tpu_torch.config import YoloSpec
    from k210_yolo_framework_tpu_torch.export import freeze
    from k210_yolo_framework_tpu_torch.models import build_network
    from k210_yolo_framework_tpu_torch.training import checkpoint as CK
    from k210_yolo_framework_tpu_torch.training.train import checked_device
    from k210_yolo_framework_tpu_torch.utils import NOTE

    device = checked_device(args.device)
    spec = YoloSpec.from_files(
        f"data/{args.train_set}_anchor.npy",
        in_hw=tuple(args.image_size),
        out_hws=tuple(args.output_size),
        class_num=args.class_num)
    net = build_network(args.model_def, spec.in_hw, spec.nanchors,
                        spec.class_num, alpha=args.depth_multiplier)
    state = CK.load_variables(args.pre_ckpt, args.model_def, net)

    out_dir = args.out_dir or str(Path(args.pre_ckpt).parent / "Freeze_save")
    arts = freeze(net, state, spec, out_dir,
                  tflite=str2bool(args.tflite),
                  tflite_int8=(str2bool(args.tflite_int8)
                               or args.tflite_dataset is not None),
                  model_def=(args.model_def if str2bool(args.reference_h5)
                             else None),
                  device=device)
    print(NOTE, f"export artifacts: {arts}")
    return arts


def parse_args(argv):
    parser = argparse.ArgumentParser()
    parser.add_argument("pre_ckpt", type=str,
                        help="checkpoint (.h5, .npz or a save_state "
                             "directory)")
    parser.add_argument("--train_set", type=str, default="voc")
    parser.add_argument("--class_num", type=int, default=20)
    parser.add_argument("--model_def", type=str, default="yolo_mobilev1")
    parser.add_argument("--depth_multiplier", type=float, default=0.75)
    parser.add_argument("--image_size", type=int, default=(224, 320),
                        nargs="+")
    parser.add_argument("--output_size", type=int, default=(7, 10, 14, 20),
                        nargs="+")
    parser.add_argument("--out_dir", type=str, default=None)
    parser.add_argument("--tflite", type=str, default="True",
                        help="no TFLite route without TensorFlow: a NOTE")
    parser.add_argument("--tflite_int8", type=str, default="False",
                        help="no TFLite route without TensorFlow: a NOTE")
    parser.add_argument("--reference_h5", type=str, default="True",
                        help="also write yolo_model_reference.h5, the "
                             "reference's Keras layout (needs h5py)")
    parser.add_argument("--tflite_dataset", type=str, default=None,
                        help="calibration images of the full-int8 TFLite "
                             "artifact: a NOTE, as --tflite_int8")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' where there is no card")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args(sys.argv[1:]))

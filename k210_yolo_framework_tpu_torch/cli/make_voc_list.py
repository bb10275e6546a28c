"""Build ``{name}_img_ann.npy`` from a darknet ``train.txt``.

    python -m k210_yolo_framework_tpu_torch.cli.make_voc_list \
        train.txt data/voc_img_ann.npy

Label files sit beside the images (``JPEGImages -> labels``,
``.jpg -> .txt``)."""

import argparse
import sys


def main(train_file: str, output_file: str):
    from k210_yolo_framework_tpu_torch.data.annotations import build_ann_list

    arr = build_ann_list(train_file, output_file)
    print(f"wrote {len(arr)} annotations to {output_file}")
    return arr


def parse_args(argv):
    parser = argparse.ArgumentParser()
    parser.add_argument("train_file", type=str, help="train.txt file path")
    parser.add_argument("output_file", type=str, help="output file path")
    return parser.parse_args(argv)


if __name__ == "__main__":
    a = parse_args(sys.argv[1:])
    main(a.train_file, a.output_file)

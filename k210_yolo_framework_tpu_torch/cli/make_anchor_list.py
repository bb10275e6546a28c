"""kmeans anchors for a training set.

    python -m k210_yolo_framework_tpu_torch.cli.make_anchor_list voc

Reads ``data/<set>_img_ann.npy`` and writes ``data/<set>_anchor.npy``
([layers, anchor_num, 2], biggest first) and, with ``--is_plot True``
where matplotlib imports, ``data/<set>_anchor.png``.  Exits 1, writing
nothing, when the anchors come out NaN ("please Rerun").  The kmeans loop
runs on the CPU (``anchors/kmeans.py``)."""

import argparse
import sys

import numpy as np


def main(args) -> int:
    from k210_yolo_framework_tpu_torch.anchors import generate_anchors
    from k210_yolo_framework_tpu_torch.cli import str2bool
    from k210_yolo_framework_tpu_torch.data.annotations import load_ann_list
    from k210_yolo_framework_tpu_torch.utils import ERROR, NOTE

    ann = load_ann_list(f"data/{args.train_set}_img_ann.npy")
    layers = len(args.out_hw) // 2
    want_plot = str2bool(args.is_plot)
    history: list = []
    centroids = generate_anchors(
        ann, tuple(args.in_hw), layers, args.anchor_num,
        max_iters=args.max_iters, is_random=str2bool(args.is_random),
        low=tuple(args.low), high=tuple(args.high),
        history_sink=history if want_plot else None)

    if np.any(np.isnan(centroids)):
        print(ERROR, "Result have NaN value please Rerun!")
        return 1
    print(NOTE, f"Now anchors are :\n{centroids}")
    np.save(f"data/{args.train_set}_anchor.npy", centroids)

    if want_plot:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print(NOTE, "matplotlib unavailable; skipping plot")
            return 0
        # the gt (w, h) scatter and each centroid's path over the iterations
        fig = plt.figure()
        if history:
            x, hist = history[0]
            plt.scatter(x[:, 0], x[:, 1], s=4, c="#9ecae1", label="gt wh")
            for j in range(hist.shape[1]):
                plt.plot(hist[:, j, 0], hist[:, j, 1], "-o", ms=2, lw=0.8)
        flat = centroids.reshape(-1, 2)
        plt.scatter(flat[:, 0], flat[:, 1], c="r", marker="x", zorder=5,
                    label="final anchors")
        plt.xlabel("w")
        plt.ylabel("h")
        plt.legend(loc="lower right", fontsize=8)
        plt.savefig(f"data/{args.train_set}_anchor.png")
        plt.close(fig)
        print(NOTE, f"anchor plot saved to data/{args.train_set}_anchor.png")
    return 0


def parse_args(argv):
    parser = argparse.ArgumentParser()
    parser.add_argument("train_set", type=str)
    parser.add_argument("--max_iters", type=int, default=10)
    parser.add_argument("--is_random", type=str, default="True")
    parser.add_argument("--is_plot", type=str, default="True")
    parser.add_argument("--in_hw", type=int, default=(224, 320), nargs="+")
    parser.add_argument("--out_hw", type=int, default=(7, 10, 14, 20),
                        nargs="+")
    parser.add_argument("--low", type=float, default=(0.0, 0.0), nargs="+")
    parser.add_argument("--high", type=float, default=(1.0, 1.0), nargs="+")
    parser.add_argument("--anchor_num", type=int, default=3)
    return parser.parse_args(argv)


if __name__ == "__main__":
    sys.exit(main(parse_args(sys.argv[1:])))

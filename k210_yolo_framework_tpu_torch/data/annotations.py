"""The reference's ``.npy`` annotation format.

Counterpart of ``k210_yolo_framework_tpu/data/annotations.py`` (a copy: the
port loads nothing of the JAX package).
``{name}_img_ann.npy`` is an object array of per-image rows
``[image_path, boxes[n, 5], (h, w)]``, boxes darknet-style
``[class, x, y, w, h]`` normalised to the original image.  Label files are
found by the reference's path rewrite: ``JPEGImages -> labels``,
``.jpg -> .txt``.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Tuple

import numpy as np

__all__ = ["read_image", "build_ann_list", "load_ann_list",
           "split_train_test"]


def read_image(path: str) -> np.ndarray:
    """RGB uint8 [h, w, 3]; grayscale promoted, alpha dropped.  PIL is
    imported here, not with the module."""
    from PIL import Image

    with Image.open(path) as im:
        return np.array(im.convert("RGB"))   # writable, for torch.from_numpy


def build_ann_list(train_file: str, output_file: str) -> np.ndarray:
    """A darknet ``train.txt`` (one image path a line) -> the annotation
    array, saved to ``output_file`` (``{name}_img_ann.npy``) and returned.
    Each row is ``[path, boxes from the label file, (h, w)]``."""
    from PIL import Image

    image_paths = [ln.strip() for ln in
                   Path(train_file).read_text().splitlines() if ln.strip()]
    rows = []
    for p in image_paths:
        label_path = re.sub(r"JPEGImages", "labels", p)
        label_path = re.sub(r"\.jpg$", ".txt", label_path)
        boxes = np.loadtxt(label_path, dtype=float, ndmin=2)
        with Image.open(p) as im:
            w, h = im.size
        rows.append(np.array([p, boxes, np.array([h, w])], dtype=object))
    arr = np.array(rows, dtype=object)
    Path(output_file).parent.mkdir(parents=True, exist_ok=True)
    np.save(output_file, arr)
    return arr


def load_ann_list(path: str) -> np.ndarray:
    return np.load(path, allow_pickle=True)


def split_train_test(ann_list: np.ndarray, validation_split: float
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(train, test): the first ``int(len * validation_split)`` rows are
    the test set, the rest train, as the reference splits."""
    n = int(len(ann_list) * validation_split)
    return ann_list[n:], ann_list[:n]

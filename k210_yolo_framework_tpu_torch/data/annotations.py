"""The reference's ``.npy`` annotation format.

Counterpart of ``k210_yolo_framework_tpu/data/annotations.py`` (a copy: the
port loads nothing of the JAX package).
``{name}_img_ann.npy`` is an object array of per-image rows
``[image_path, boxes[n, 5], (h, w)]``, boxes darknet-style
``[class, x, y, w, h]`` normalised to the original image.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["read_image", "load_ann_list", "split_train_test"]


def read_image(path: str) -> np.ndarray:
    """RGB uint8 [h, w, 3]; grayscale promoted, alpha dropped.  PIL is
    imported here, not with the module."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def load_ann_list(path: str) -> np.ndarray:
    return np.load(path, allow_pickle=True)


def split_train_test(ann_list: np.ndarray, validation_split: float
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(train, test): the first ``int(len * validation_split)`` rows are
    the test set, the rest train, as the reference splits."""
    n = int(len(ann_list) * validation_split)
    return ann_list[n:], ann_list[:n]

"""Frozen configuration specs.

The port's own copy of ``k210_yolo_framework_tpu/config.py`` (numpy only):
``YoloSpec``, ``voc_spec``, ``VOC_ANCHORS`` and the training hyperparameters
``TrainConfig``.  The port imports nothing of the JAX package;
``tests/test_torch_config.py`` holds the two copies equal field by field.

``YoloSpec`` is a frozen, hashable dataclass: per-device constants derived
from it are cached on it (``ops/yolo_head_pallas._geometry_on``,
``ops/codec._grid_consts_on``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["VOC_ANCHORS", "TrainConfig", "YoloSpec", "voc_spec"]


@dataclasses.dataclass(frozen=True)
class YoloSpec:
    """Static description of a YOLOv3-style detector head.

    Attributes
    ----------
    in_hw:
        network input (height, width); reference default (224, 320).
    out_hws:
        per-output-layer grid (height, width); reference default
        ((7, 10), (14, 20)).
    class_num:
        number of classes (VOC: 20).
    anchors:
        normalised anchor (w, h) pairs, shape [layers, anchor_num, 2], the
        ``data/{set}_anchor.npy`` layout.  Layer 0 holds the biggest anchors.
    """

    in_hw: Tuple[int, int]
    out_hws: Tuple[Tuple[int, int], ...]
    class_num: int
    anchors: Tuple[Tuple[Tuple[float, float], ...], ...]

    # ---- constructors -----------------------------------------------------

    @classmethod
    def create(cls, in_hw, out_hws, class_num, anchors) -> "YoloSpec":
        """Build a spec from array-likes (anchors: [L, A, 2])."""
        anchors = np.asarray(anchors, dtype=np.float64)
        if anchors.ndim != 3 or anchors.shape[-1] != 2:
            raise ValueError(f"anchors must be [layers, anchor_num, 2], got "
                             f"{anchors.shape}")
        out_hws = tuple(tuple(int(v) for v in hw)
                        for hw in np.reshape(np.asarray(out_hws), (-1, 2)))
        if len(out_hws) != anchors.shape[0]:
            raise ValueError(f"{len(out_hws)} output grids but "
                             f"{anchors.shape[0]} anchor layers")
        return cls(
            in_hw=tuple(int(v) for v in in_hw),
            out_hws=out_hws,
            class_num=int(class_num),
            anchors=tuple(tuple(tuple(float(v) for v in a) for a in layer)
                          for layer in anchors),
        )

    @classmethod
    def from_files(cls, anchor_file: str, in_hw=(224, 320),
                   out_hws=((7, 10), (14, 20)),
                   class_num: int = 20) -> "YoloSpec":
        """Load anchors from the reference's ``.npy`` format."""
        return cls.create(in_hw, out_hws, class_num, np.load(anchor_file))

    # ---- derived geometry (plain numpy) -----------------------------------

    @property
    def nlayers(self) -> int:
        return len(self.out_hws)

    @property
    def nanchors(self) -> int:
        return len(self.anchors[0])

    @property
    def nchannels(self) -> int:
        """Per-anchor channel count: x, y, w, h, conf, classes."""
        return 5 + self.class_num

    def anchors_np(self) -> np.ndarray:
        """Anchors as float32 [layers, anchor_num, 2]."""
        return np.asarray(self.anchors, dtype=np.float32)

    def out_hw_np(self) -> np.ndarray:
        """[layers, 2] grid (h, w)."""
        return np.asarray(self.out_hws, dtype=np.int32)

    def grid_wh(self, layer: int) -> np.ndarray:
        """1 / (out_w, out_h) for ``layer``."""
        h, w = self.out_hws[layer]
        return np.array([1.0 / w, 1.0 / h], dtype=np.float32)

    def xy_offset(self, layer: int) -> np.ndarray:
        """Grid-cell (x, y) offsets, shape [h, w, 1, 2]."""
        h, w = self.out_hws[layer]
        grid_y = np.tile(np.arange(h, dtype=np.float32).reshape(-1, 1, 1, 1),
                         (1, w, 1, 1))
        grid_x = np.tile(np.arange(w, dtype=np.float32).reshape(1, -1, 1, 1),
                         (h, 1, 1, 1))
        return np.concatenate([grid_x, grid_y], axis=-1)

    def wh_scale(self, layer: int) -> np.ndarray:
        """anchors * grid_wh, shape [anchor_num, 2]."""
        return self.anchors_np()[layer] * self.grid_wh(layer)

    def label_shapes(self, batch: int | None = None):
        """Per-layer label shapes [h, w, anchor_num, 5 + class_num]."""
        lead = () if batch is None else (batch,)
        return [lead + hw + (self.nanchors, self.nchannels)
                for hw in self.out_hws]


# 20-class VOC demo spec anchors (the reference's data/voc_anchor.npy).
VOC_ANCHORS = (
    ((0.76120044, 0.57155991), (0.6923348, 0.88535553),
     (0.47163042, 0.34163313)),
    ((0.33340788, 0.70065861), (0.18124964, 0.38986752),
     (0.08497349, 0.1527057)),
)


def voc_spec(in_hw=(224, 320), out_hws=((7, 10), (14, 20)),
             class_num=20) -> YoloSpec:
    """The reference demo configuration."""
    return YoloSpec.create(in_hw, out_hws, class_num, np.asarray(VOC_ANCHORS))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters; defaults follow the reference's
    ``keras_train.py`` argument parser."""

    batch_size: int = 16
    max_epochs: int = 10
    init_learning_rate: float = 0.001
    learning_rate_decay_factor: float = 0.0  # keras Adam `decay` semantics
    obj_weight: float = 5.0
    noobj_weight: float = 0.5
    wh_weight: float = 0.5
    obj_thresh: float = 0.7
    iou_thresh: float = 0.3
    validation_split: float = 0.1
    rand_seed: int = 6
    augment: bool = True
    # pruning
    is_prune: bool = False
    prune_initial_sparsity: float = 0.5
    prune_final_sparsity: float = 0.9
    prune_end_epoch: int = 5
    prune_frequency: int = 100

"""``Helper``: the reference's ``tools.utils.Helper`` surface on the port.

Counterpart of ``k210_yolo_framework_tpu/compat.py``, method for method:
constructed from the annotation and anchor ``.npy`` files, it owns the
train / test split, the label codec, the one-image pipeline, the batched
datasets and drawing, each delegating to the port's modules
(``config.YoloSpec``, ``ops.codec``, ``ops.letterbox``, ``ops.augment``,
``data.pipeline``).

The image pipeline runs on ``device`` (keyword, default ``cuda``; the CPU
only when asked for).  Where the JAX facade splits a PRNG key, a CPU
``torch.Generator`` is split per call (a fresh seed drawn from it for each
image or batch): the first is seeded from ``SeedSequence`` entropy, so no
two calls apply one fixed transform.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from k210_yolo_framework_tpu_torch.config import YoloSpec
from k210_yolo_framework_tpu_torch.data import annotations as ANN
from k210_yolo_framework_tpu_torch.data import pipeline as PL
from k210_yolo_framework_tpu_torch.ops import codec as C
from k210_yolo_framework_tpu_torch.ops import letterbox as LB

__all__ = ["Helper"]


def _split(generator: torch.Generator) -> torch.Generator:
    """A new generator seeded from ``generator``'s next draw."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    return torch.Generator().manual_seed(seed)


class Helper:
    """The reference's constructor contract: (annotation npy, class_num,
    anchor npy, in_hw, out_hw [[h, w], ...] or flat, validation_split)."""

    def __init__(self, image_ann: Optional[str], class_num: int,
                 anchors: Optional[str], in_hw: Tuple[int, int],
                 out_hw, validation_split: float = 0.1, *, device="cuda"):
        self.class_num = class_num
        self.validation_split = validation_split
        self.device = torch.device(device)
        if np.ndim(out_hw) == 2:  # [[h, w], ...], any number of layers
            out_hws = tuple(tuple(int(v) for v in row)
                            for row in np.asarray(out_hw))
        else:                     # flat [h0, w0, h1, w1, ...]
            flat = [int(v) for v in np.asarray(out_hw).ravel()]
            out_hws = tuple(zip(flat[0::2], flat[1::2]))
        if anchors is not None:
            self.spec = YoloSpec.from_files(anchors, in_hw=tuple(in_hw),
                                            out_hws=tuple(out_hws),
                                            class_num=class_num)
            self.anchors = self.spec.anchors_np()
        else:
            self.spec = None
            self.anchors = None
        self.in_hw = tuple(in_hw)

        self.train_list: Optional[np.ndarray] = None
        self.test_list: Optional[np.ndarray] = None
        if image_ann is not None:
            ann = ANN.load_ann_list(image_ann)
            # the reference's split: the first n are the test set
            self.train_list, self.test_list = ANN.split_train_test(
                ann, validation_split)

        self.train_dataset: Optional[Iterator] = None
        self.test_dataset: Optional[Iterator] = None
        self.train_epoch_step = 0
        self.test_epoch_step = 0
        self._aug_gen: Optional[torch.Generator] = None

    # ------------------------------------------------------- label codec --

    def box_to_label(self, true_box: np.ndarray) -> List[np.ndarray]:
        """[n, 5] normalised (class, x, y, w, h) -> per-layer grid labels."""
        boxes, valid = C.pad_boxes(np.asarray(true_box, np.float32))
        labels = C.encode_labels(torch.from_numpy(boxes),
                                 torch.from_numpy(valid), self.spec)
        return [lab.numpy() for lab in labels]

    def label_to_box(self, labels, thresh: float = 0.7) -> np.ndarray:
        """The inverse of :meth:`box_to_label`: [n, 5]."""
        rows, valid = C.decode_labels(
            [torch.as_tensor(np.asarray(lab)) for lab in labels], self.spec,
            thresh)
        return rows.numpy()[valid.numpy()]

    # ----------------------------------------------------- image pipeline --

    def _read_img(self, path: str) -> np.ndarray:
        """uint8 RGB, alpha dropped, gray promoted."""
        return ANN.read_image(path)

    def _process_img(self, img: np.ndarray,
                     true_box: Optional[np.ndarray] = None,
                     is_training: bool = False, is_resize: bool = True,
                     generator: Optional[torch.Generator] = None):
        """Letterbox (and augment when training), then /max normalise, on
        ``device``.  Returns (img float32 [in_h, in_w, 3], boxes)."""
        from k210_yolo_framework_tpu_torch.ops.augment import (
            augment_image_and_boxes,
        )

        hw = torch.tensor([img.shape[:2]], dtype=torch.int32,
                          device=self.device)
        out = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
        boxes = None if true_box is None else np.asarray(true_box, np.float32)
        if is_resize:
            out = LB.letterbox_image(out[None], hw, self.in_hw)[0]
            if boxes is not None:
                boxes = LB.letterbox_boxes(
                    torch.from_numpy(boxes)[None].to(self.device), hw,
                    self.in_hw)[0].cpu().numpy()
        if is_training:
            if generator is None:
                if self._aug_gen is None:
                    self._aug_gen = torch.Generator().manual_seed(
                        int(np.random.SeedSequence().entropy % (2 ** 63)))
                generator = _split(self._aug_gen)
            padded, valid = C.pad_boxes(boxes if boxes is not None
                                        else np.zeros((0, 5), np.float32))
            out, padded, valid = augment_image_and_boxes(
                out, torch.from_numpy(padded).to(self.device),
                torch.from_numpy(valid).to(self.device), generator=generator)
            boxes = padded.cpu().numpy()[valid.cpu().numpy()]
        out = LB.normalize_image(out.to(torch.float32))
        return out.cpu().numpy(), boxes

    # ---------------------------------------------------------- datasets --

    def set_dataset(self, batch_size: int, rand_seed: int = 0,
                    is_training: bool = True):
        """Infinite (images, labels) iterators of ``device`` tensors over
        the train and test lists, as the reference's datasets."""
        def make(ann_list, training):
            pipe = PL.DataPipeline(ann_list, batch_size, rand_seed)
            pp = PL.make_preprocess_fn(self.spec, is_training=training)
            gen = torch.Generator().manual_seed(rand_seed)

            def batches():
                for hb in pipe:
                    yield pp(*hb.to(self.device), generator=_split(gen))
            return batches(), pipe.epoch_step

        self.batch_size = batch_size
        self.train_dataset, self.train_epoch_step = make(self.train_list,
                                                         is_training)
        # the reference repeats before batching: only an empty test list
        # has no dataset
        if self.test_list is not None and len(self.test_list) > 0:
            self.test_dataset, self.test_epoch_step = make(self.test_list,
                                                           False)

    # ------------------------------------------------------------- drawing --

    def draw_box(self, img: np.ndarray, true_box: np.ndarray) -> np.ndarray:
        """Rectangles and class ids on a copy of the image; boxes are
        normalised (class, x, y, w, h)."""
        from k210_yolo_framework_tpu_torch.inference import (
            Detections,
            draw_detections,
        )

        h, w = img.shape[:2]
        tb = np.asarray(true_box, np.float32)
        cy, cx = tb[:, 2] * h, tb[:, 1] * w
        bh, bw = tb[:, 4] * h, tb[:, 3] * w
        boxes = np.stack([cy - bh / 2, cx - bw / 2, cy + bh / 2,
                          cx + bw / 2], 1)
        det = Detections(boxes, np.ones(len(tb)), tb[:, 0].astype(int))
        return draw_detections(img, det)

    # --------------------------------------------------- coord transforms --

    def center_to_corner(self, boxes: np.ndarray,
                         to_all_scale: bool = True) -> np.ndarray:
        """(x, y, w, h) -> (x1, y1, x2, y2), in pixels when
        ``to_all_scale``."""
        from k210_yolo_framework_tpu_torch.ops.boxes import (
            center_to_corner as f,
        )

        return f(torch.as_tensor(np.asarray(boxes, np.float32)),
                 in_hw=self.in_hw if to_all_scale else None).numpy()

    def corner_to_center(self, boxes: np.ndarray,
                         from_all_scale: bool = True) -> np.ndarray:
        """(x1, y1, x2, y2) -> (x, y, w, h)."""
        from k210_yolo_framework_tpu_torch.ops.boxes import (
            corner_to_center as f,
        )

        return f(torch.as_tensor(np.asarray(boxes, np.float32)),
                 in_hw=self.in_hw if from_all_scale else None).numpy()

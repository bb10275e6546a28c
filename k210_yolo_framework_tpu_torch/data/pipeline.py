"""Input pipeline: threaded host JPEG decode, then one on-device preprocess.

Counterpart of ``k210_yolo_framework_tpu/data/pipeline.py`` (``HostBatch``,
``stage_image``, ``make_preprocess_fn``, ``DataPipeline``,
``synthetic_ann_list``).  The host only decodes each JPEG into a fixed zero
canvas with its true (h, w) and the padded gt boxes.  The device then
letterboxes, augments (training), normalises each image by its max and
encodes the grid labels, batched.

``DataPipeline`` decodes either in the C++ loader's worker threads
(``native.NativeLoader``, its own mt19937_64 shuffle) or in Python threads
with PIL (a numpy-seeded permutation per epoch).  Each path yields the JAX
package's batches for the same seed and path, and the default is the JAX
package's: the C++ loader whenever it builds.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from k210_yolo_framework_tpu_torch import native
from k210_yolo_framework_tpu_torch.config import YoloSpec
from k210_yolo_framework_tpu_torch.data.annotations import read_image
from k210_yolo_framework_tpu_torch.ops import augment as A
from k210_yolo_framework_tpu_torch.ops import codec as C
from k210_yolo_framework_tpu_torch.ops import letterbox as LB
from k210_yolo_framework_tpu_torch.utils.trace import span

__all__ = ["CANVAS_HW", "HostBatch", "stage_image", "make_preprocess_fn",
           "DataPipeline", "synthetic_ann_list"]

# Staging canvas: covers the raw dataset (VOC images are <= 500 px a side).
CANVAS_HW = (512, 512)


class HostBatch(NamedTuple):
    """What the host hands the device, all fixed-shape numpy arrays (or,
    after :meth:`to`, tensors)."""

    canvases: np.ndarray  # [B, canvas_h, canvas_w, 3] uint8
    img_hws: np.ndarray   # [B, 2] int32 true (h, w)
    boxes: np.ndarray     # [B, MAX_BOXES, 5] float32 (class, x, y, w, h)
    valid: np.ndarray     # [B, MAX_BOXES] bool

    def to(self, device) -> "HostBatch":
        """The same batch as tensors on ``device``."""
        return HostBatch(*(torch.as_tensor(np.asarray(a)).to(device)
                           for a in self))


def stage_image(img: np.ndarray, canvas_hw: Tuple[int, int]):
    """Place ``img`` top-left in a zero canvas; an oversized image is first
    shrunk on the host (PIL bilinear) to fit.  Returns (canvas, (h, w))."""
    h, w = img.shape[:2]
    ch, cw = canvas_hw
    if h > ch or w > cw:
        from PIL import Image

        s = min(ch / h, cw / w)
        nh, nw = max(1, int(h * s)), max(1, int(w * s))
        img = np.asarray(Image.fromarray(img).resize((nw, nh),
                                                     Image.BILINEAR))
        h, w = nh, nw
    canvas = np.zeros((ch, cw, 3), np.uint8)
    canvas[:h, :w] = img
    return canvas, np.array([h, w], np.int32)


def make_preprocess_fn(spec: YoloSpec, is_training: bool,
                       dtype: Optional[torch.dtype] = None) -> Callable:
    """The on-device preprocess:

    (canvases u8 [B, Ch, Cw, 3], img_hws [B, 2], boxes [B, N, 5],
     valid [B, N], generator=None, params=None)
      -> (images [B, in_h, in_w, 3] of ``dtype``, per-layer labels)

    letterbox -> augment (training only; draws from ``generator`` or takes
    ``params``, see ``ops/augment.py``) -> per-image /max -> label encode.
    ``dtype`` (default float32) is the pixel dtype of letterbox, augment
    and normalise; pass bfloat16 when the net computes in bf16.  Box and
    label math stays fp32.

    With ``slots=(lo, hi)`` (a data-parallel rank's share, see
    ``parallel.slot_range``) the four arrays are the whole global batch, on
    the host, and the result is slots ``[lo, hi)`` of the global batch's
    result on ``device`` (default: where the arrays are).  Training draws
    the global batch's augment (the same generator calls as without
    ``slots``, so every rank's generator stays in step), and only the
    slots' source images (``augment.slot_draws``) are copied to
    ``device``, letterboxed and augmented with the slots' draws; without
    augment the sources are the contiguous rows ``[lo, hi)``.  Its stages
    are spans (``utils.trace``): ``preprocess.letterbox``,
    ``preprocess.augment``, ``preprocess.normalize``,
    ``preprocess.encode``."""
    dtype = dtype or torch.float32

    def rank_share(batch, generator, params, slots, device):
        lo, hi = slots
        if is_training:
            if params is None:
                params = A.draw_params(len(batch[1]), spec.in_hw,
                                       generator=generator)
            src, params = A.slot_draws(params, lo, hi)
        else:
            src = torch.arange(lo, hi)
        picked = (torch.as_tensor(a[src.to(a.device)] if torch.is_tensor(a)
                                  else np.asarray(a)[src.numpy()])
                  for a in batch)
        return tuple(t if device is None else t.to(device)
                     for t in picked), params

    def preprocess(canvases, img_hws, boxes, valid, generator=None,
                   params=None, slots=None, device=None):
        if slots is not None:
            (canvases, img_hws, boxes, valid), params = rank_share(
                (canvases, img_hws, boxes, valid), generator, params, slots,
                device)
        with span("preprocess.letterbox"):
            imgs = LB.letterbox_image(canvases, img_hws, spec.in_hw, dtype)
            boxes = LB.letterbox_boxes(boxes.to(torch.float32), img_hws,
                                       spec.in_hw)
        if is_training:
            with span("preprocess.augment"):
                imgs, boxes, valid = A.augment_batch(imgs, boxes, valid,
                                                     generator=generator,
                                                     params=params)
        with span("preprocess.normalize"):
            imgs = LB.normalize_images(imgs)
        with span("preprocess.encode"):
            return imgs, tuple(C.encode_labels_batch(boxes, valid, spec))

    return preprocess


class DataPipeline:
    """Seeded, infinite, threaded loader over an annotation list; iterating
    yields :class:`HostBatch`es.  ``use_native``: True takes the C++ loader
    (raises if it does not build), False the PIL threads, None (default)
    the C++ loader when ``native.available()``."""

    def __init__(self, ann_list: np.ndarray, batch_size: int, seed: int,
                 canvas_hw=CANVAS_HW, num_workers: Optional[int] = None,
                 prefetch: int = 4, use_native: Optional[bool] = None):
        if len(ann_list) == 0:
            raise ValueError("empty annotation list")
        if num_workers is None:
            num_workers = min(8, max(2, os.cpu_count() or 1))
        self.ann_list = ann_list
        self.batch_size = batch_size
        self.seed = seed
        self.canvas_hw = canvas_hw
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.epoch_step = len(ann_list) // batch_size
        if use_native is None:
            use_native = native.available()
        self.use_native = use_native

    def _load_one(self, row):
        path, boxes, _hw = row
        canvas, img_hw = stage_image(read_image(str(path)), self.canvas_hw)
        padded, valid = C.pad_boxes(np.copy(boxes))
        return canvas, img_hw, padded, valid

    def _index_stream(self) -> Iterator[int]:
        rng = np.random.default_rng(self.seed)
        while True:
            for i in rng.permutation(len(self.ann_list)):
                yield int(i)

    def _iter_native(self) -> Iterator[HostBatch]:
        """Decode and stage in the C++ worker threads; only the gt-box
        padding stays in Python.  A file that fails to decode raises
        IOError."""
        loader = native.NativeLoader([str(r[0]) for r in self.ann_list],
                                     self.canvas_hw, self.batch_size,
                                     self.seed, self.num_workers,
                                     self.prefetch)
        try:
            while True:
                canvases, hws, idxs = loader.next()
                padded, valid = zip(*(C.pad_boxes(np.copy(self.ann_list[i][1]))
                                      for i in idxs))
                yield HostBatch(canvases, hws, np.stack(padded),
                                np.stack(valid))
        finally:
            loader.close()

    def __iter__(self) -> Iterator[HostBatch]:
        if self.use_native:
            yield from self._iter_native()
            return
        stream = self._index_stream()
        # no context manager: a dropped infinite generator must not block
        # in a join at teardown, so shut down without waiting
        pool = ThreadPoolExecutor(self.num_workers)
        try:
            def submit_batch():
                idxs = [next(stream) for _ in range(self.batch_size)]
                return [pool.submit(self._load_one, self.ann_list[i])
                        for i in idxs]

            pending = [submit_batch() for _ in range(self.prefetch)]
            while True:
                futs = pending.pop(0)
                pending.append(submit_batch())
                items = [f.result() for f in futs]
                yield HostBatch(*(np.stack(x) for x in zip(*items)))
        finally:
            pool.shutdown(wait=False, cancel_futures=True)


def synthetic_ann_list(tmpdir: str, n: int = 24, class_num: int = 20,
                       seed: int = 0) -> np.ndarray:
    """A small self-contained dataset: smooth photo-like JPEGs written to
    ``tmpdir`` and random boxes, in the annotation row format.  The same
    seed gives the JAX package's files and rows."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        h = int(rng.integers(200, 500))
        w = int(rng.integers(200, 500))
        yy = np.linspace(0, 3 * np.pi, h)[:, None]
        xx = np.linspace(0, 3 * np.pi, w)[None, :]
        phase = rng.uniform(0, np.pi, (3,))
        base = np.stack([np.sin(yy + p) * np.cos(xx - p) for p in phase], -1)
        img = ((base * 0.5 + 0.5) * 220 + rng.normal(0, 6, (h, w, 3)))
        img = np.clip(img, 0, 255).astype(np.uint8)
        path = f"{tmpdir}/img_{i}.jpg"
        Image.fromarray(img).save(path, quality=90)
        nb = int(rng.integers(1, 6))
        cls = rng.integers(0, class_num, (nb, 1)).astype(float)
        xy = rng.uniform(0.2, 0.8, (nb, 2))
        wh = rng.uniform(0.1, 0.4, (nb, 2))
        rows.append(np.array([path, np.hstack([cls, xy, wh]),
                              np.array([h, w])], dtype=object))
    return np.array(rows, dtype=object)

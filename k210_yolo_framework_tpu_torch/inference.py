"""End-to-end inference: uint8 images in, detections out.

Counterpart of ``k210_yolo_framework_tpu/inference.py`` (``Detections``,
``VOC_LABELS``, ``Predictor`` and ``draw_detections``).  The batched path is
the system's main serving path:

  1. letterbox the uint8 canvases (in ``compute_dtype``, stored as uint8);
  2. run the net in ``compute_dtype`` with each image's 1/max folded in
     after the stem conv;
  3. decode + per-class greedy NMS in one fused head
     (``ops/yolo_head_pallas.fused_decode_nms``: the CUDA kernel for CUDA
     tensors, its plain version for CPU tensors).
"""

from __future__ import annotations

import copy
from typing import List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from k210_yolo_framework_tpu_torch.config import YoloSpec
from k210_yolo_framework_tpu_torch.models.yolonet import YoloNet
from k210_yolo_framework_tpu_torch.ops import letterbox as LB
from k210_yolo_framework_tpu_torch.ops.nms import NmsResult
from k210_yolo_framework_tpu_torch.ops.yolo_head_pallas import fused_decode_nms

__all__ = ["Detections", "Predictor", "VOC_LABELS", "draw_detections",
           "stack_detections"]

# 20-class VOC label table
VOC_LABELS = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]


class Detections(NamedTuple):
    boxes: np.ndarray    # [n, 4] yxyx pixels in the ORIGINAL image
    scores: np.ndarray   # [n]
    classes: np.ndarray  # [n] int


def _detections(res: NmsResult, b: int) -> Detections:
    valid = res.valid[b]
    return Detections(res.boxes[b][valid], res.scores[b][valid],
                      res.classes[b][valid])


def stack_detections(dets: List[Detections]) -> NmsResult:
    """Per-image Detections -> one padded NmsResult of numpy arrays
    ([B, N] with N the largest count), the layout
    ``utils/detmatch.assert_detections_close`` reads."""
    n = max([1] + [len(d.scores) for d in dets])
    boxes = np.zeros((len(dets), n, 4), np.float32)
    scores = np.zeros((len(dets), n), np.float32)
    classes = np.zeros((len(dets), n), np.int32)
    valid = np.zeros((len(dets), n), bool)
    for b, d in enumerate(dets):
        k = len(d.scores)
        boxes[b, :k], scores[b, :k], classes[b, :k] = d.boxes, d.scores, d.classes
        valid[b, :k] = True
    return NmsResult(boxes, scores, classes, valid)


class Predictor:
    """Holds a net on ``device`` and serves predictions.

    ``state`` is the state dict to serve (e.g. from
    ``training.checkpoint.load_h5``), or None to serve the net's own
    weights.  The net is copied, so the caller's module is left as it was.
    ``compute_dtype`` (default fp32) is the dtype of the letterbox products
    and of every conv; BN, activations and the head stay fp32.  ``device``
    is required: a CUDA device that is not there raises, and nothing falls
    back to the CPU."""

    def __init__(self, net: YoloNet, state: Optional[Mapping[str, torch.Tensor]],
                 spec: YoloSpec, obj_thresh: float = 0.7,
                 iou_thresh: float = 0.3, class_softmax: bool = False,
                 max_out: int = 30, compute_dtype: Optional[torch.dtype] = None,
                 *, device):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Predictor(device={str(device)!r}): no CUDA "
                               "device is available")
        net = copy.deepcopy(net)
        if state is not None:
            net.load_state_dict(state)
        net.eval().requires_grad_(False)
        self.net = net.to(device, memory_format=torch.channels_last)
        self.spec = spec
        self.obj_thresh = obj_thresh
        self.iou_thresh = iou_thresh
        self.class_softmax = class_softmax
        self.max_out = max_out
        self.compute_dtype = compute_dtype or torch.float32
        self.device = device

    def _head(self, preds: List[torch.Tensor],
              img_hws: torch.Tensor) -> NmsResult:
        return fused_decode_nms(preds, self.spec, img_hws, self.obj_thresh,
                                self.iou_thresh, self.max_out,
                                self.class_softmax)

    def _forward(self, imgs_u8: torch.Tensor) -> List[torch.Tensor]:
        """Letterboxed uint8 [B, h, w, 3] -> per-layer fp32 head logits
        [B, h, w, a, 5 + C], with each image's 1/max folded into the stem."""
        inv_scale = 1.0 / torch.clamp_min(
            torch.amax(imgs_u8, dim=(1, 2, 3)).to(torch.float32), 1e-12)
        preds = self.net(imgs_u8, input_scale=inv_scale,
                         dtype=self.compute_dtype)
        return [p.to(torch.float32) for p in preds]

    # ---- single image -----------------------------------------------------

    @torch.inference_mode()
    def _run_single(self, img_u8: torch.Tensor,
                    img_hw: torch.Tensor) -> NmsResult:
        img = LB.letterbox_image(img_u8[None], img_hw[None], self.spec.in_hw,
                                 torch.float32).to(torch.uint8)
        return self._head(self._forward(img), img_hw[None])

    def predict_image(self, img: np.ndarray) -> Detections:
        """img: [h, w, 3] uint8 original image."""
        img_t = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
        hw = torch.tensor(img.shape[:2], dtype=torch.int32, device=self.device)
        res = self._run_single(img_t, hw)
        return _detections(NmsResult(*(t.cpu().numpy() for t in res)), 0)

    # ---- batched serving path (fixed canvas) ------------------------------

    @torch.inference_mode()
    def _forward_batch(self, canvases_u8: torch.Tensor,
                       img_hws: torch.Tensor) -> List[torch.Tensor]:
        """Canvases [B, H, W, 3] uint8 (image top-left, zeros elsewhere) ->
        per-layer fp32 head logits."""
        # uint8 store: exact, the values are truncated integers
        imgs = LB.letterbox_image(canvases_u8, img_hws, self.spec.in_hw,
                                  self.compute_dtype).to(torch.uint8)
        return self._forward(imgs)

    @torch.inference_mode()
    def _run_batch(self, canvases_u8: torch.Tensor,
                   img_hws: torch.Tensor) -> NmsResult:
        return self._head(self._forward_batch(canvases_u8, img_hws), img_hws)

    def predict_batch(self, canvases: np.ndarray,
                      img_hws: np.ndarray) -> List[Detections]:
        """canvases [B, H, W, 3] uint8; img_hws [B, 2] true (h, w) sizes."""
        c = torch.from_numpy(np.ascontiguousarray(canvases)).to(self.device)
        h = torch.as_tensor(np.asarray(img_hws), dtype=torch.int32).to(
            self.device)
        res = self._run_batch(c, h)
        res = NmsResult(*(t.cpu().numpy() for t in res))
        return [_detections(res, b) for b in range(canvases.shape[0])]


def draw_detections(img: np.ndarray, det: Detections,
                    labels: Optional[List[str]] = None,
                    colormap: Optional[List[Tuple[int, int, int]]] = None
                    ) -> np.ndarray:
    """Box and label rendering with PIL (imported here: the package itself
    does not need it)."""
    from PIL import Image, ImageDraw

    from k210_yolo_framework_tpu.utils.colormap import COLORMAP

    colormap = colormap or COLORMAP
    labels = labels or VOC_LABELS
    pil = Image.fromarray(img)
    drawer = ImageDraw.Draw(pil)
    thickness = (img.shape[0] + img.shape[1]) // 300
    for box, score, cls in zip(det.boxes, det.scores, det.classes):
        # random or diverged weights can decode exp(wh) to inf: clamp to
        # the image frame before the int conversion
        box = np.nan_to_num(np.asarray(box, np.float64),
                            posinf=max(img.shape[:2]) * 2.0, neginf=-1.0)
        top, left, bottom, right = box
        top = max(0, int(np.floor(top + 0.5)))
        left = max(0, int(np.floor(left + 0.5)))
        bottom = min(img.shape[0], int(np.floor(bottom + 0.5)))
        right = min(img.shape[1], int(np.floor(right + 0.5)))
        color = tuple(colormap[int(cls) % len(colormap)])
        for j in range(max(thickness, 1)):
            drawer.rectangle([left + j, top + j, right - j, bottom - j],
                             outline=color)
        name = labels[int(cls)] if int(cls) < len(labels) else str(int(cls))
        drawer.text((left, max(top - 12, 0)), f"{name} {score:.2f}",
                    fill=color)
    return np.asarray(pil)

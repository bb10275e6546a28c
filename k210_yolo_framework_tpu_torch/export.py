"""Model export: the freeze stage.

Counterpart of ``k210_yolo_framework_tpu/export.py``.  StableHLO and TFLite
have no torch counterpart without TensorFlow, so the port's artifacts are
``torch.export`` programs (``ExportedProgram``, saved with
``torch.export.save`` as ``.pt2`` and read back with ``torch.export.load``):

  * ``export_raw``: the raw-output forward at fp32, ``[B, h, w,
    a * (5 + C)]`` per layer (the JAX ``export_stablehlo`` view);
  * ``export_serving``: the whole serving program, uint8 canvases and
    their sizes in, NMS'd boxes out: the live Predictor's letterbox
    (stored as uint8) and net (1/max folded past the stem), then
    ``ops/decode.decode_outputs`` and ``ops/nms.batched_nms`` over the
    full candidate set, with no hand-written kernel in it, so that it runs
    wherever torch does.  A quantized Predictor's program holds the int8
    kernels and their scales as int8 and fp32 buffers and dequantizes them
    inside;
  * ``freeze``: those two as ``.pt2`` files, the weights as ``.npz`` and,
    where h5py imports, as the native ``.h5`` and the reference Keras
    ``.h5``; a NOTE says what is skipped.  It prints the JAX freeze's
    input and output node lines.
"""

from __future__ import annotations

import copy
import importlib.util
from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from k210_yolo_framework_tpu_torch.config import YoloSpec
from k210_yolo_framework_tpu_torch.inference import Predictor, folded_logits
from k210_yolo_framework_tpu_torch.models.yolonet import YoloNet
from k210_yolo_framework_tpu_torch.ops import letterbox as LB
from k210_yolo_framework_tpu_torch.ops.decode import (
    decode_outputs,
    num_candidates,
)
from k210_yolo_framework_tpu_torch.ops.nms import batched_nms
from k210_yolo_framework_tpu_torch.training import checkpoint as CK
from k210_yolo_framework_tpu_torch.utils.console import NOTE

__all__ = ["ServingProgram", "export_raw", "export_serving", "freeze"]


class _RawProgram(nn.Module):
    def __init__(self, net: YoloNet):
        super().__init__()
        self.net = net

    def forward(self, x: torch.Tensor):
        return tuple(self.net.forward_raw(x, dtype=torch.float32))


def _served_net(net: YoloNet, state: Optional[Mapping[str, torch.Tensor]],
                device) -> YoloNet:
    net = copy.deepcopy(net)
    if state is not None:
        net.load_state_dict(state)
    return net.eval().requires_grad_(False).to(device)


def export_raw(net: YoloNet, state: Optional[Mapping[str, torch.Tensor]],
               batch: int = 1, *, device) -> torch.export.ExportedProgram:
    """The raw-output forward at fp32 as a program, traced on ``device``:
    x [batch, H, W, 3] float32 -> one [batch, h, w, a * (5 + C)] per
    layer."""
    net = _served_net(net, state, device)
    x = torch.zeros((batch, *net.in_hw, 3), device=device)
    return torch.export.export(_RawProgram(net), (x,))


class ServingProgram(nn.Module):
    """A Predictor's serving path without its kernels:
    (canvases uint8 [B, H, W, 3], img_hws int32 [B, 2]) -> the
    ``NmsResult`` fields (boxes, scores, classes, valid), class-major.
    The forward is the live Predictor's (the letterbox stored as uint8,
    each image's 1/max folded past the stem conv; JAX's export divides the
    image by its max first), so the program serves the live logits; its
    NMS is the plain ``batched_nms``, not the head kernel."""

    def __init__(self, predictor, top_k: Optional[int] = None):
        super().__init__()
        predictor._require_calibrated()
        self.spec = predictor.spec
        self.compute_dtype = predictor.compute_dtype
        self.module_dtype = predictor.module_dtype
        self.thresholds = (predictor.obj_thresh, predictor.iou_thresh,
                           predictor.max_out)
        self.class_softmax = predictor.class_softmax
        # the full candidate set by default, as the live head: a smaller
        # top_k can cut the pool a dense low-threshold scene feeds NMS
        self.top_k = num_candidates(self.spec) if top_k is None else top_k
        self.net = copy.deepcopy(predictor.net)
        self.qnames = list(predictor.qweights)
        for i, (q, scale) in enumerate(predictor.qweights.values()):
            self.register_buffer(f"q{i}", q)
            self.register_buffer(f"scale{i}", scale)

    def forward(self, canvases: torch.Tensor, img_hws: torch.Tensor):
        imgs = LB.letterbox_image(canvases, img_hws, self.spec.in_hw,
                                  self.compute_dtype).to(torch.uint8)
        weights = {name: getattr(self, f"q{i}").to(torch.float32)
                   * getattr(self, f"scale{i}")
                   for i, name in enumerate(self.qnames)}
        preds = folded_logits(self.net, weights, imgs, self.module_dtype)
        boxes, scores = decode_outputs(preds, self.spec, img_hws,
                                       self.class_softmax)
        obj, iou, max_out = self.thresholds
        return tuple(batched_nms(boxes, scores, obj, iou, max_out,
                                 top_k=self.top_k))


def export_serving(predictor, batch: int = 1, canvas_hw=None,
                   top_k: Optional[int] = None
                   ) -> torch.export.ExportedProgram:
    """The whole serving program of ``predictor`` (on its device) for
    ``batch`` canvases of ``canvas_hw`` (default the net's input size)."""
    program = ServingProgram(predictor, top_k)
    canvas_hw = canvas_hw or predictor.spec.in_hw
    canvases = torch.zeros((batch, *canvas_hw, 3), dtype=torch.uint8,
                           device=predictor.device)
    hws = torch.tensor([list(canvas_hw)] * batch, dtype=torch.int32,
                       device=predictor.device)
    return torch.export.export(program, (canvases, hws))


def freeze(net: YoloNet, state: Optional[Mapping[str, torch.Tensor]],
           spec: YoloSpec, out_dir: str, batch: int = 1, tflite: bool = True,
           tflite_int8: bool = False, rep_images: Optional[np.ndarray] = None,
           model_def: Optional[str] = None, *, device) -> Dict[str, str]:
    """Write the export artifacts, traced on ``device``, into ``out_dir``;
    returns {artifact: path}.  ``yolo_model.pt2`` (raw forward), ``yolo_serving.pt2`` (the
    fp32 serving program), ``yolo_model.npz``; ``yolo_model.h5`` and, with
    ``model_def``, ``yolo_model_reference.h5`` where h5py imports.  The
    TFLite requests (``tflite``, ``tflite_int8`` with or without
    ``rep_images``) have no torch route and each prints a NOTE."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    served = _served_net(net, state, "cpu")
    arts: Dict[str, str] = {}

    raw_path = out / "yolo_model.pt2"
    torch.export.save(export_raw(served, None, batch, device=device),
                      raw_path)
    arts["program"] = str(raw_path)

    serving_path = out / "yolo_serving.pt2"
    torch.export.save(export_serving(
        Predictor(served, None, spec, device=device), batch=batch),
        serving_path)
    arts["serving"] = str(serving_path)

    npz_path = out / "yolo_model.npz"
    CK.save_npz(str(npz_path), served)
    arts["npz"] = str(npz_path)

    if importlib.util.find_spec("h5py") is None:
        print(NOTE, "h5py unavailable: skipping yolo_model.h5"
              + (" and yolo_model_reference.h5" if model_def else "")
              + " (yolo_model.npz holds the same weights)")
    else:
        h5_path = out / "yolo_model.h5"
        CK.save_h5(str(h5_path), served)
        arts["h5"] = str(h5_path)
        if model_def is not None:
            from k210_yolo_framework_tpu_torch.port import save_reference_h5

            ref_path = out / "yolo_model_reference.h5"
            save_reference_h5(str(ref_path),
                              CK.flat_from_state_dict(served.state_dict()),
                              model_def)
            arts["reference_h5"] = str(ref_path)

    for wanted, what in ((tflite, ".tflite"),
                         (tflite_int8 or rep_images is not None,
                          "int8 .tflite")):
        if wanted:
            print(NOTE, f"tensorflow unavailable: skipping the {what} "
                  "artifact (torch.export programs + npz written)")

    print("Model Inputs Node:  image:0", (batch, net.in_hw[0], net.in_hw[1], 3),
          "float32")
    for layer, hw in enumerate(spec.out_hws):
        print(f"Model Outputs Node: l{layer + 1}/raw:0",
              (batch, hw[0], hw[1], spec.nanchors * spec.nchannels),
              "float32")
    return arts

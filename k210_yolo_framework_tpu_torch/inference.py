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

``quantize`` selects the JAX package's quantized modes: ``'int8'`` serves
from per-channel int8 conv kernels held on the device as int8 plus fp32
scales and dequantized inside each call; ``'int8_act'``,
``'int8_act_sym'`` and ``'int8_act_cal'`` run the dense convs int8 x int8
-> int32 (``models.layers.Int8Act``: dynamic affine, dynamic symmetric and
calibrated static activation ranges; :meth:`Predictor.calibrate`).

``stem_mode`` selects the JAX package's serving stem variant
(``models.layers.ConvBN.stem_mode``): in ``'patches'`` stage 1 emits the
stem conv's im2col patches instead of the canvas
(``ops/letterbox.letterbox_stem_patches``) and the stem contracts them;
``'nativeconv'`` quantizes the stem too under the int8-activation modes.
:meth:`Predictor.make_sharded_runner` serves a batch over a
``parallel.make_mesh`` mesh, one process a device, in every quantize and
stem mode: a data shard a data rank, and on a mesh with a model or space
axis each rank's channels and rows of the forward
(``parallel/sharded.py``).

Each stage of a serving call is a ``utils.trace.span``, a
``torch.profiler`` range while a profiler records and nothing otherwise:
``serve.batch`` over ``serve.h2d``, ``serve.letterbox``, ``serve.net``,
``serve.head``, ``serve.d2h`` and ``serve.detections`` (the sharded
runner: ``serve.batch`` over ``serve.h2d`` and the three between).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from k210_yolo_framework_tpu_torch.config import YoloSpec
from k210_yolo_framework_tpu_torch.models.layers import (
    STEM_MODES,
    Conv,
    Int8Act,
    name_convs,
)
from k210_yolo_framework_tpu_torch.models.yolonet import YoloNet
from k210_yolo_framework_tpu_torch.ops import letterbox as LB
from k210_yolo_framework_tpu_torch.ops.nms import NmsResult
from k210_yolo_framework_tpu_torch.ops.yolo_head_pallas import fused_decode_nms
from k210_yolo_framework_tpu_torch.quantize import QTensor, quantize_state
from k210_yolo_framework_tpu_torch.utils.trace import span

__all__ = ["Detections", "Predictor", "QUANTIZE_MODES", "VOC_LABELS",
           "draw_detections", "folded_logits", "net_call",
           "stack_detections", "stem_input"]

QUANTIZE_MODES = (None, "int8", "int8_act", "int8_act_sym", "int8_act_cal")

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


def net_call(net: YoloNet, weights: Mapping[str, torch.Tensor],
             imgs: torch.Tensor, **kwargs) -> List[torch.Tensor]:
    """``net(imgs, **kwargs)``, with ``weights`` (by parameter name) in
    place of the net's own where given: the int8 mode's dequantized
    kernels."""
    if not weights:
        return net(imgs, **kwargs)
    return torch.func.functional_call(net, dict(weights), (imgs,), kwargs,
                                      strict=False)


def _takes_patches(stem: torch.nn.Module) -> bool:
    """Whether ``stem``'s conv is the one ``letterbox_stem_patches`` emits
    patches for: 3x3, stride 2, padded by 1 on every side."""
    conv = next(m for m in stem.modules() if isinstance(m, Conv))
    return (tuple(conv.weight.shape[2:]) == (3, 3)
            and conv.strides == (2, 2) and conv.pads == ((1, 1), (1, 1)))


def stem_input(canvases_u8: torch.Tensor, img_hws: torch.Tensor,
               in_hw: Tuple[int, int], dtype: torch.dtype,
               stem_mode: str = "default") -> torch.Tensor:
    """Canvases [B, H, W, 3] -> the net's uint8 input under ``stem_mode``:
    the letterboxed images [B, h, w, 3], or in ``'patches'`` the stem's
    im2col patches [B, Ho, 3, Wo, 3, 3] (the stems that take patches are
    3x3, stride 2, padded by 1).  Either is exact as uint8: the values are
    truncated integers.  ``dtype`` is that of the resample products."""
    with span("serve.letterbox"):
        if stem_mode == "patches":
            out = LB.letterbox_stem_patches(canvases_u8, img_hws, in_hw,
                                            dtype=dtype)
        else:
            out = LB.letterbox_image(canvases_u8, img_hws, in_hw, dtype)
        return out.to(torch.uint8)


def folded_logits(net: YoloNet, weights: Mapping[str, torch.Tensor],
                  imgs_u8: torch.Tensor, dtype,
                  **forward) -> List[torch.Tensor]:
    """Letterboxed uint8 [B, h, w, 3] (or the stem's patches of them,
    whose max is the image's: every pixel lies in some patch) -> per-layer
    fp32 head logits, each image's 1/max folded in after the stem conv
    (``dtype``: the net's compute dtype or an ``Int8Act``; ``forward``:
    the net's other keywords, ``shard``)."""
    with span("serve.net"):
        inv_scale = 1.0 / torch.clamp_min(torch.amax(
            imgs_u8, dim=tuple(range(1, imgs_u8.ndim))).to(torch.float32),
            1e-12)
        preds = net_call(net, weights, imgs_u8, input_scale=inv_scale,
                         dtype=dtype, **forward)
        return [p.to(torch.float32) for p in preds]


class Predictor:
    """Holds a net on ``device`` and serves predictions.

    ``state`` is the state dict to serve (e.g. from
    ``training.checkpoint.load_h5``), or None to serve the net's own
    weights.  The net is copied, so the caller's module is left as it was.
    ``compute_dtype`` (default fp32) is the dtype of the letterbox products
    and of every conv; BN, activations and the head stay fp32.  It may be
    an ``Int8Act``, which implies its quantize mode (a conflicting
    ``quantize`` raises).  ``quantize`` is one of ``QUANTIZE_MODES`` (see
    the module docstring).  ``stem_mode`` is one of ``layers.STEM_MODES``,
    set on the Predictor's copy of the net: ``'patches'`` needs a builder
    with a stride-2 stem and ``quantize`` None or ``'int8'``.  ``device`` is
    required: a CUDA device that is not there raises, and nothing falls
    back to the CPU."""

    def __init__(self, net: YoloNet, state: Optional[Mapping[str, torch.Tensor]],
                 spec: YoloSpec, obj_thresh: float = 0.7,
                 iou_thresh: float = 0.3, class_softmax: bool = False,
                 max_out: int = 30, compute_dtype=None,
                 quantize: Optional[str] = None, stem_mode: str = "default",
                 *, device):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Predictor(device={str(device)!r}): no CUDA "
                               "device is available")
        compute_dtype = compute_dtype or torch.float32
        if isinstance(compute_dtype, Int8Act):
            # the sentinel is a quantize request; its affine / static bits
            # win (the mode strings cannot say symmetric and calibrated)
            act = compute_dtype
            implied = "int8_act_cal" if act.static else (
                "int8_act" if act.affine else "int8_act_sym")
            if quantize is None:
                quantize = implied
            elif quantize != implied:
                raise ValueError(
                    f"conflicting quantize modes: compute_dtype={act!r} "
                    f"implies {implied!r} but quantize={quantize!r}")
            compute_dtype = act.out_dtype
            self.int8_act = Int8Act(compute_dtype, affine=act.affine,
                                    static=act.static)
        elif quantize in ("int8_act", "int8_act_sym", "int8_act_cal"):
            self.int8_act = Int8Act(compute_dtype,
                                    affine=quantize != "int8_act_sym",
                                    static=quantize == "int8_act_cal")
        else:
            self.int8_act = None
        if stem_mode not in STEM_MODES:
            raise ValueError(f"unknown stem_mode {stem_mode!r}")
        if stem_mode != "default":
            if not hasattr(net, "stem_mode"):
                raise ValueError(
                    f"stem_mode={stem_mode!r} unsupported by "
                    f"{type(net).__name__}")
            if stem_mode == "patches" and not _takes_patches(net.stem):
                raise ValueError(
                    f"stem_mode='patches' needs a builder with a stride-2 "
                    f"stem (yolo_mobilev1/yolo_mobilev2); "
                    f"{type(net).__name__}'s stride-1 stem would "
                    f"inflate pixel traffic ~9x")
            if stem_mode == "patches" and quantize not in (None, "int8"):
                raise ValueError(
                    "stem_mode='patches' supports quantize=None or 'int8'")
        if quantize not in QUANTIZE_MODES:
            raise ValueError(f"unknown quantize mode {quantize!r}")
        self.quantize = quantize
        net = copy.deepcopy(net)
        # on the copy: the caller's net keeps its own stem
        net.stem_mode = stem_mode
        self.stem_mode = stem_mode
        if state is not None:
            net.load_state_dict(state)
        net.eval().requires_grad_(False)
        self.net = name_convs(net.to(device,
                                     memory_format=torch.channels_last))
        self.qweights: Dict[str, QTensor] = {}
        if quantize == "int8":
            self._hold_int8()
        elif self.int8_act is not None:
            # the int8 convs' quantized kernels, made once: the weights
            # are frozen
            for conv in self.net.modules():
                if isinstance(conv, Conv) and conv.int8_capable:
                    conv.hold_int8_weight()
        self.spec = spec
        self.obj_thresh = obj_thresh
        self.iou_thresh = iou_thresh
        self.class_softmax = class_softmax
        self.max_out = max_out
        self.compute_dtype = compute_dtype
        self.device = device
        self._cal_checked = False   # see _require_calibrated

    @property
    def module_dtype(self):
        """What the net's forward takes as ``dtype``."""
        return self.int8_act or self.compute_dtype

    def _hold_int8(self) -> None:
        """Quantize the conv kernels and keep only their int8 form and
        scales on the device: each fp32 kernel leaves the net, and
        :meth:`_materialize` supplies it to each call."""
        params = dict(self.net.named_parameters())
        for name, v in quantize_state(params).items():
            if isinstance(v, QTensor):
                self.qweights[name] = QTensor(
                    v.q.contiguous(memory_format=torch.channels_last), v.scale)
                mod_name, leaf = name.rsplit(".", 1)
                del self.net.get_submodule(mod_name)._parameters[leaf]

    def _materialize(self) -> Dict[str, torch.Tensor]:
        """The int8 kernels dequantized (``q.float() * scale``), by name;
        empty in the other modes."""
        return {k: v.q.to(torch.float32) * v.scale
                for k, v in self.qweights.items()}

    def weight_bytes(self) -> int:
        """Bytes of the weights and statistics this Predictor holds on its
        device (int8 kernels and their scales in the int8 mode)."""
        held = list(self.net.parameters()) + list(self.net.buffers())
        held += [t for v in self.qweights.values() for t in v]
        return sum(t.numel() * t.element_size() for t in held)

    def calibrate(self, canvases: np.ndarray,
                  img_hws: np.ndarray) -> "Predictor":
        """Record each int8 conv's activation range for
        ``quantize='int8_act_cal'`` from a representative batch: the
        canvases are letterboxed and normalised by their max as in
        training, and go through an unquantized recording forward; ranges
        widen over calls.  The next serve checks them again.  Returns
        self."""
        if self.quantize != "int8_act_cal":
            raise ValueError(
                "calibrate() only applies to quantize='int8_act_cal'")
        act = Int8Act(self.compute_dtype, affine=self.int8_act.affine,
                      static=True, calibrate=True)
        c = torch.from_numpy(np.ascontiguousarray(canvases)).to(self.device)
        h = torch.as_tensor(np.asarray(img_hws), dtype=torch.int32).to(
            self.device)
        with torch.no_grad():
            imgs = LB.letterbox_image(c, h, self.spec.in_hw,
                                      self.compute_dtype)
            imgs = LB.normalize_images(imgs).to(self.compute_dtype)
            net_call(self.net, self._materialize(), imgs, dtype=act)
        self._cal_checked = False
        return self

    def _require_calibrated(self) -> None:
        """In the ``int8_act_cal`` mode, raise unless some conv holds a
        nonzero range: zero ranges (never calibrated) would saturate every
        activation."""
        if self.quantize != "int8_act_cal" or self._cal_checked:
            return
        for conv in self.net.modules():   # the int8 convs hold ranges
            if hasattr(conv, "act_min") and bool(
                    (conv.act_min != 0) | (conv.act_max != 0)):
                self._cal_checked = True
                return
        raise RuntimeError(
            "quantize='int8_act_cal' serves from calibrated activation "
            "ranges: call calibrate(canvases, img_hws) with a "
            "representative batch first")

    def _head(self, preds: List[torch.Tensor],
              img_hws: torch.Tensor) -> NmsResult:
        with span("serve.head"):
            return fused_decode_nms(preds, self.spec, img_hws,
                                    self.obj_thresh, self.iou_thresh,
                                    self.max_out, self.class_softmax)

    def _forward(self, imgs_u8: torch.Tensor) -> List[torch.Tensor]:
        """Letterboxed uint8 [B, h, w, 3] -> per-layer fp32 head logits
        [B, h, w, a, 5 + C], with each image's 1/max folded into the stem."""
        return folded_logits(self.net, self._materialize(), imgs_u8,
                             self.module_dtype)

    # ---- single image -----------------------------------------------------

    def _letterbox_for_stem(self, canvases_u8: torch.Tensor,
                            img_hws: torch.Tensor,
                            dtype: torch.dtype) -> torch.Tensor:
        """Canvases -> the net's uint8 input under the Predictor's
        ``stem_mode`` (``stem_input``)."""
        return stem_input(canvases_u8, img_hws, self.spec.in_hw, dtype,
                          self.stem_mode)

    @torch.inference_mode()
    def _run_single(self, img_u8: torch.Tensor,
                    img_hw: torch.Tensor) -> NmsResult:
        img = self._letterbox_for_stem(img_u8[None], img_hw[None],
                                       torch.float32)
        return self._head(self._forward(img), img_hw[None])

    def predict_image(self, img: np.ndarray) -> Detections:
        """img: [h, w, 3] uint8 original image."""
        with span("serve.batch"):
            self._require_calibrated()
            with span("serve.h2d"):
                img_t = torch.from_numpy(np.ascontiguousarray(img)).to(
                    self.device)
                hw = torch.tensor(img.shape[:2], dtype=torch.int32,
                                  device=self.device)
            res = self._run_single(img_t, hw)
            with span("serve.d2h"):
                res = NmsResult(*(t.cpu().numpy() for t in res))
            with span("serve.detections"):
                return _detections(res, 0)

    # ---- batched serving path (fixed canvas) ------------------------------

    @torch.inference_mode()
    def _forward_batch(self, canvases_u8: torch.Tensor,
                       img_hws: torch.Tensor) -> List[torch.Tensor]:
        """Canvases [B, H, W, 3] uint8 (image top-left, zeros elsewhere) ->
        per-layer fp32 head logits."""
        return self._forward(self._letterbox_for_stem(
            canvases_u8, img_hws, self.compute_dtype))

    @torch.inference_mode()
    def _run_batch(self, canvases_u8: torch.Tensor,
                   img_hws: torch.Tensor) -> NmsResult:
        return self._head(self._forward_batch(canvases_u8, img_hws), img_hws)

    # ---- serving over a device mesh ---------------------------------------

    def make_sharded_runner(self, mesh):
        """Serving over a ``parallel.make_mesh`` mesh, one process a device,
        each holding this Predictor.  Returns ``run(canvases [B, H, W, 3],
        img_hws [B, 2]) -> NmsResult`` on this Predictor's device, which
        every rank calls with the whole batch (as JAX's one controller is
        given it), B divisible by the data axis's size dp.  Each rank
        copies only its data coordinate's contiguous B / dp shard to its
        device; every quantize mode and stem mode serves.

        On a pure data-parallel mesh each rank runs the whole serving
        program on its shard (``_run_batch``, head kernel included), as
        JAX's ``shard_map`` does: a dynamic int8 activation range is the
        shard's own.  With a model or space axis it runs JAX's one GSPMD
        program over the global batch: it makes the shard's net input
        (letterboxed canvases, or the stem's patches) and takes each
        image's 1/max whole, runs its part of the forward (its channels and
        rows, ``parallel/sharded.py``; in the ``int8`` mode from the
        dequantized kernels), whose head outputs come back whole, and runs
        the head kernel on the shard.  There a dynamic int8 activation
        range is that of the whole global tensor, every data shard, row
        and channel of it (one max all-reduce a quantized conv whose
        input is spread over ranks, ``parallel.sharded.tensor_range``).

        The fixed-shape result fields are all-gathered over the data axis,
        so every rank returns the whole batch's result.  The parameters
        are replicated: rank 0 of the data axis (of the world, with a
        model or space axis) broadcasts its weights, quantized kernels and
        calibrated ranges to the others here.  So in ``int8_act_cal`` every
        rank serves that rank's ranges: a rank that did not calibrate gets
        them here (its own, where it has any, are replaced), and the check
        that they were calibrated runs after the broadcast, on every rank
        alike."""
        import torch.distributed as dist

        from k210_yolo_framework_tpu_torch.parallel import mesh as PM
        from k210_yolo_framework_tpu_torch.parallel.sharded import (
            ShardContext,
        )

        group = PM.data_group(mesh)
        dp = dist.get_world_size(group)
        shard = None
        if PM.axis_size(mesh, PM.MODEL_AXIS) * PM.axis_size(
                mesh, PM.SPACE_AXIS) > 1:
            shard = ShardContext(mesh)
        held_by = PM.world_group(mesh) if shard is not None else group
        src = dist.get_global_rank(held_by, 0)
        if self.quantize == "int8_act_cal":
            # every rank holds the range buffers the broadcast fills
            for conv in self.net.modules():
                if isinstance(conv, Conv) and conv.int8_capable:
                    conv.act_ranges(self.device)
        held = list(self.net.parameters()) + list(self.net.buffers())
        held += [t for v in self.qweights.values() for t in v]
        with torch.no_grad():
            for t in held:
                dist.broadcast(t, src=src, group=held_by)
        self._cal_checked = False
        self._require_calibrated()

        def gather(t: torch.Tensor) -> torch.Tensor:
            # as uint8: gloo has no bool all-gather
            part = t.to(torch.uint8) if t.dtype == torch.bool else t
            parts = [torch.empty_like(part) for _ in range(dp)]
            dist.all_gather(parts, part.contiguous(), group=group)
            out = torch.cat(parts)
            return out.to(torch.bool) if t.dtype == torch.bool else out

        def run(canvases, img_hws) -> NmsResult:
            with span("serve.batch"):
                part = slice(*PM.slot_range(canvases.shape[0], mesh))
                with span("serve.h2d"):
                    c = torch.as_tensor(
                        np.ascontiguousarray(canvases[part])
                        if isinstance(canvases, np.ndarray)
                        else canvases[part]).to(self.device)
                    h = torch.as_tensor(np.asarray(img_hws[part])
                                        if isinstance(img_hws, np.ndarray)
                                        else img_hws[part],
                                        dtype=torch.int32).to(self.device)
                if shard is None:
                    res = self._run_batch(c, h)
                else:
                    with torch.inference_mode():
                        imgs = self._letterbox_for_stem(c, h,
                                                        self.compute_dtype)
                        res = self._head(folded_logits(
                            self.net, self._materialize(), imgs,
                            self.module_dtype, shard=shard), h)
                return NmsResult(*(gather(t) for t in res))

        return run

    def predict_batch(self, canvases: np.ndarray,
                      img_hws: np.ndarray) -> List[Detections]:
        """canvases [B, H, W, 3] uint8; img_hws [B, 2] true (h, w) sizes."""
        with span("serve.batch"):
            self._require_calibrated()
            with span("serve.h2d"):
                c = torch.from_numpy(np.ascontiguousarray(canvases)).to(
                    self.device)
                h = torch.as_tensor(np.asarray(img_hws),
                                    dtype=torch.int32).to(self.device)
            res = self._run_batch(c, h)
            with span("serve.d2h"):
                res = NmsResult(*(t.cpu().numpy() for t in res))
            with span("serve.detections"):
                return [_detections(res, b)
                        for b in range(canvases.shape[0])]


def draw_detections(img: np.ndarray, det: Detections,
                    labels: Optional[List[str]] = None,
                    colormap: Optional[List[Tuple[int, int, int]]] = None
                    ) -> np.ndarray:
    """Box and label rendering with PIL (imported here: the package itself
    does not need it)."""
    from PIL import Image, ImageDraw

    from k210_yolo_framework_tpu_torch.utils.colormap import COLORMAP

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
            # a box thinner than the outline (or clipped away) stops early:
            # PIL refuses a rectangle whose corners cross
            if right - j < left + j or bottom - j < top + j:
                break
            drawer.rectangle([left + j, top + j, right - j, bottom - j],
                             outline=color)
        name = labels[int(cls)] if int(cls) < len(labels) else str(int(cls))
        drawer.text((left, max(top - 12, 0)), f"{name} {score:.2f}",
                    fill=color)
    return np.asarray(pil)

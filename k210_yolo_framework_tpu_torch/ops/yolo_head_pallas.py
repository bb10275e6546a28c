"""Fused YOLO head: decode + letterbox inverse + per-class greedy NMS.

Counterpart of ``k210_yolo_framework_tpu/ops/yolo_head_pallas.py``.

``fused_decode_nms`` dispatches by the device of its input: on the CPU it
runs ``fused_decode_nms_reference`` (plain torch, whole batch at once); on a
CUDA device it launches the hand-written kernel ``csrc/yolo_head.cu`` (one
thread block per image and group of class rows, one warp per row; the rows'
layout and G from ``ops/nms_pallas.greedy_plan``: in shared memory, or, for
more candidates than a block holds, in a global scratch tensor) or raises.
There is no fallback from the kernel to the plain version.

Reference math: decode as ``ops/decode.py`` of the JAX package (sigmoid xy +
grid offset, exp wh * anchor), with darknet's per-layer ``scale_x_y`` s
where the spec has one (``sigmoid * s - (s - 1) / 2``; s = 1 leaves the
sigmoid as it is, bit for bit), ``correct_box`` letterbox inverse with ROUND
semantics, score = sigmoid(cls) * sigmoid(conf) or the firmware's softmax
flavour over the real classes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from k210_yolo_framework_tpu_torch.config import YoloSpec
from k210_yolo_framework_tpu_torch.ops import _build
from k210_yolo_framework_tpu_torch.ops.letterbox import _const
from k210_yolo_framework_tpu_torch.ops.nms import NmsResult, finish_winners
from k210_yolo_framework_tpu_torch.ops.nms_pallas import (
    global_rows,
    greedy_plan,
    greedy_select_loop,
)

__all__ = ["candidate_geometry", "letterbox_inverse_params",
           "fused_decode_nms", "fused_decode_nms_reference"]

_NEG = -1e9


def candidate_geometry(spec: YoloSpec) -> np.ndarray:
    """[8, N] per-candidate constants: gx, gy, 1/gw, 1/gh, aw, ah, s and
    -(s - 1) / 2, with s the layer's ``spec.xy_scale`` (1 and 0 without
    one).

    Candidate order: layers concatenated, within a layer row-major
    (gy, gx, anchor) — the order of the head outputs flattened from
    [h, w, a]."""
    cols = []
    anchors = spec.anchors_np()
    for l, (h, w) in enumerate(spec.out_hws):
        gy, gx, a = np.meshgrid(np.arange(h), np.arange(w),
                                np.arange(spec.nanchors), indexing="ij")
        aw = anchors[l][:, 0][a]
        ah = anchors[l][:, 1][a]
        n = h * w * spec.nanchors
        s = spec.xy_scale(l)
        cols.append(np.stack([
            gx.reshape(n), gy.reshape(n),
            np.full(n, 1.0 / w), np.full(n, 1.0 / h),
            aw.reshape(n), ah.reshape(n),
            np.full(n, s), np.full(n, -(s - 1.0) / 2.0)]))
    return np.concatenate(cols, axis=1).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _geometry_on(spec: YoloSpec, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(candidate_geometry(spec)).to(device)


def letterbox_inverse_params(img_hws: torch.Tensor, in_hw) -> torch.Tensor:
    """[B, 8] (off_y, off_x, sy, sx, img_h, img_w, 0, 0): the ``correct_box``
    factors.  ``torch.round`` rounds half to even, as ``jnp.round`` does;
    extents clamp at 1 so a degenerate aspect cannot give inf boxes."""
    image_shape = img_hws.to(torch.float32)                        # [B, 2]
    input_shape = _const((float(in_hw[0]), float(in_hw[1])), img_hws.device)
    new_shape = torch.round(image_shape * torch.amin(
        input_shape / image_shape, dim=-1, keepdim=True))
    new_shape = torch.clamp_min(new_shape, 1.0)
    offset = (input_shape - new_shape) / 2.0 / input_shape
    scale = input_shape / new_shape
    return torch.cat([offset, scale, image_shape, torch.zeros_like(offset)],
                     dim=-1)


def _flatten_preds(preds: Sequence[torch.Tensor], classes: int) -> torch.Tensor:
    """Per-layer [B, h, w, a, 5+C] logits -> one [B, N, 5+C] fp32 tensor."""
    if any(p.shape[-1] != 5 + classes for p in preds):
        raise ValueError(f"head outputs {[tuple(p.shape) for p in preds]} "
                         f"do not end in 5 + {classes} entries")
    flat = [p.flatten(1, -2) for p in preds]
    return torch.cat(flat, dim=1).to(torch.float32).contiguous()


def _decode(p: torch.Tensor, geom: torch.Tensor, lbox: torch.Tensor, *,
            classes: int, class_softmax: bool):
    """The kernel's decode on plain tensors: p [B, N, 5+C] logits, geom
    [8, N], lbox [B, 8] -> box corners y0, x0, y1, x1 [B, 1, N] and scores
    [B, C, N]."""
    gx, gy = geom[0], geom[1]
    inv_gw, inv_gh = geom[2], geom[3]
    aw, ah = geom[4], geom[5]
    s, shift = geom[6], geom[7]                     # scale_x_y: 1, 0 or s

    cx = (torch.sigmoid(p[:, :, 0]) * s + shift + gx) * inv_gw     # [B, N]
    cy = (torch.sigmoid(p[:, :, 1]) * s + shift + gy) * inv_gh
    bw = torch.exp(p[:, :, 2]) * aw
    bh = torch.exp(p[:, :, 3]) * ah

    off_y, off_x = lbox[:, 0:1], lbox[:, 1:2]                      # [B, 1]
    sy, sx = lbox[:, 2:3], lbox[:, 3:4]
    ih, iw = lbox[:, 4:5], lbox[:, 5:6]
    oy, ox = (cy - off_y) * sy, (cx - off_x) * sx
    oh, ow = bh * sy, bw * sx
    y0 = ((oy - oh * 0.5) * ih)[:, None, :]                        # [B, 1, N]
    x0 = ((ox - ow * 0.5) * iw)[:, None, :]
    y1 = ((oy + oh * 0.5) * ih)[:, None, :]
    x1 = ((ox + ow * 0.5) * iw)[:, None, :]

    conf = torch.sigmoid(p[:, :, 4])[:, None, :]                   # [B, 1, N]
    cls_logits = p[:, :, 5:5 + classes].transpose(1, 2)            # [B, C, N]
    if class_softmax:
        # softmax over the real classes; the sum runs in class order, as
        # the kernel's does, so the two round alike
        mx = torch.amax(cls_logits, dim=1, keepdim=True)
        ex = torch.exp(cls_logits - mx)
        total = ex[:, 0:1]
        for k in range(1, classes):
            total = total + ex[:, k:k + 1]
        scores = ex / total * conf
    else:
        scores = torch.sigmoid(cls_logits) * conf
    return y0, x0, y1, x1, scores


def _decode_and_select(p: torch.Tensor, geom: torch.Tensor,
                       lbox: torch.Tensor, *, classes: int, max_out: int,
                       iou_thresh: float, class_softmax: bool,
                       stop_below: float, live: list | None = None):
    """The kernel's math on plain tensors: p [B, N, 5+C] logits, geom
    [8, N], lbox [B, 8] -> five [B, C, max_out] winner buffers."""
    y0, x0, y1, x1, scores = _decode(p, geom, lbox, classes=classes,
                                     class_softmax=class_softmax)
    return greedy_select_loop(scores, y0, x0, y1, x1, max_out, iou_thresh,
                              stop_below=stop_below, live=live)


def fused_decode_nms_reference(preds: Sequence[torch.Tensor], spec: YoloSpec,
                               img_hws: torch.Tensor,
                               score_thresh: float = 0.7,
                               iou_thresh: float = 0.3, max_out: int = 30,
                               class_softmax: bool = False) -> NmsResult:
    """Plain-torch version of the fused head, on any device: the same
    decode, then the same greedy loop as ``ops/nms_pallas``.

    preds: per layer [B, h, w, a, 5+C] raw logits; img_hws [B, 2] (h, w)."""
    p = _flatten_preds(preds, spec.class_num)
    geom = _geometry_on(spec, p.device)
    lbox = letterbox_inverse_params(img_hws.to(p.device), spec.in_hw)
    w_s, w_y0, w_x0, w_y1, w_x1 = _decode_and_select(
        p, geom, lbox, classes=spec.class_num, max_out=max_out,
        iou_thresh=iou_thresh, class_softmax=class_softmax,
        stop_below=score_thresh)
    return finish_winners(w_s, torch.stack([w_y0, w_x0, w_y1, w_x1], dim=-1),
                   score_thresh)


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("yolo_head")
    lib.yolo_head_decode_nms.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.yolo_head_decode_nms.restype = ctypes.c_int
    lib.yolo_head_error_string.argtypes = [ctypes.c_int]
    lib.yolo_head_error_string.restype = ctypes.c_char_p
    lib.yolo_head_max_dynamic_smem.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.yolo_head_max_dynamic_smem.restype = ctypes.c_int
    for fn in (lib.yolo_head_smem_bytes, lib.yolo_head_scratch_bytes):
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_size_t
    lib.yolo_head_max_rows.argtypes = []
    lib.yolo_head_max_rows.restype = ctypes.c_int
    lib.yolo_head_blocks_per_sm.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.yolo_head_blocks_per_sm.restype = ctypes.c_int
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"yolo_head {what} failed: "
                           + lib.yolo_head_error_string(err).decode())


@functools.cache
def _smem_limit(device: torch.device) -> int:
    """The most dynamic shared memory one block may ask for on ``device``:
    the opt-in limit less the kernel's static shared memory (227 KB on an
    H100)."""
    lib = _kernel_lib()
    nbytes = ctypes.c_int(0)
    with torch.cuda.device(device):
        _check(lib, lib.yolo_head_max_dynamic_smem(ctypes.byref(nbytes)),
               "shared-memory query")
    return nbytes.value


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _plan(device: torch.device, bsz: int, n: int, classes: int) -> tuple:
    """(layout, G) for a launch of this shape (``greedy_plan``)."""
    lib = _kernel_lib()
    return greedy_plan(bsz, classes, _sms(device),
                       lambda g: lib.yolo_head_smem_bytes(n, g),
                       _smem_limit(device), lib.yolo_head_max_rows())


def _blocks_per_sm(device: torch.device, n: int, rows: int,
                   layout: str) -> int:
    """Blocks of ``rows`` class rows of n candidates in ``layout`` one SM
    of ``device`` holds at once (CUDA's occupancy calculator)."""
    lib = _kernel_lib()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        _check(lib, lib.yolo_head_blocks_per_sm(
            n, rows, int(layout == "global"), ctypes.byref(blocks)),
            "occupancy query")
    return blocks.value


def _launch(p: torch.Tensor, geom: torch.Tensor, lbox: torch.Tensor, *,
            classes: int, max_out: int, iou_thresh: float,
            score_thresh: float, class_softmax: bool,
            rows: int | None = None, layout: str | None = None):
    """Run ``csrc/yolo_head.cu`` on the current stream; returns the winner
    buffers [B, C, M] and [B, C, M, 4].  ``rows`` class rows a block and
    their ``layout`` default to ``_plan``'s; a forced ``rows`` must fit
    shared memory unless ``layout`` is ``"global"``, which runs the global
    path at any N (default G: ``global_rows``)."""
    bsz, n, e = p.shape
    for name, t in (("logits", p), ("geometry", geom), ("lbox", lbox)):
        if t.device != p.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous float32 tensor on "
                             f"{p.device}, got {t.dtype} on {t.device}")
    if e != 5 + classes or geom.shape != (8, n) or lbox.shape != (bsz, 8):
        raise ValueError(f"shape mismatch: logits {tuple(p.shape)}, geometry "
                         f"{tuple(geom.shape)}, lbox {tuple(lbox.shape)}, "
                         f"classes {classes}")
    if layout not in (None, "global"):
        raise ValueError(f"layout {layout!r}: None (planned) or 'global'")
    out_scores = torch.empty((bsz, classes, max_out), dtype=torch.float32,
                             device=p.device)
    out_boxes = torch.empty((bsz, classes, max_out, 4), dtype=torch.float32,
                            device=p.device)
    if bsz == 0 or classes == 0 or max_out == 0:
        return out_scores, out_boxes
    lib = _kernel_lib()
    max_rows = lib.yolo_head_max_rows()
    if layout == "global":
        if rows is None:
            rows = global_rows(bsz, classes, _sms(p.device), max_rows)
        elif not 1 <= rows <= max_rows:
            raise ValueError(f"{rows} class rows a block: 1 to {max_rows}")
    elif rows is None:
        layout, rows = _plan(p.device, bsz, n, classes)
    elif not 1 <= rows <= max_rows or \
            lib.yolo_head_smem_bytes(n, rows) > _smem_limit(p.device):
        raise ValueError(f"{rows} class rows a block of {n} candidates do "
                         f"not fit one block's shared memory (1 to "
                         f"{max_rows} rows)")
    scratch = None
    if layout == "global":
        blocks = bsz * -(-classes // rows)
        scratch = torch.empty(
            blocks * lib.yolo_head_scratch_bytes(n, rows) // 4,
            dtype=torch.float32, device=p.device)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.yolo_head_decode_nms(
            p.data_ptr(), geom.data_ptr(), lbox.data_ptr(),
            out_scores.data_ptr(), out_boxes.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            bsz, n, classes, rows, max_out, iou_thresh, score_thresh,
            int(class_softmax), stream)
    _check(lib, err, "kernel launch")
    fused_decode_nms.launches += 1
    if scratch is not None:
        fused_decode_nms.global_launches += 1
    return out_scores, out_boxes


def fused_decode_nms(preds: Sequence[torch.Tensor], spec: YoloSpec,
                     img_hws: torch.Tensor, score_thresh: float = 0.7,
                     iou_thresh: float = 0.3, max_out: int = 30,
                     class_softmax: bool = False) -> NmsResult:
    """preds: per layer [B, h, w, a, 5+C] raw logits; img_hws [B, 2] (h, w).

    CPU tensors go through ``fused_decode_nms_reference``; CUDA tensors
    through the kernel at any N, counted in ``fused_decode_nms.launches``
    (and those on the global path also in ``.global_launches``)."""
    device = preds[0].device
    if device.type == "cpu":
        return fused_decode_nms_reference(preds, spec, img_hws, score_thresh,
                                          iou_thresh, max_out, class_softmax)
    if device.type != "cuda":
        raise ValueError(f"fused_decode_nms: no kernel for device {device}")
    p = _flatten_preds(preds, spec.class_num)
    lbox = letterbox_inverse_params(img_hws.to(device), spec.in_hw)
    out_scores, out_boxes = _launch(
        p, _geometry_on(spec, device), lbox.contiguous(),
        classes=spec.class_num, max_out=max_out, iou_thresh=iou_thresh,
        score_thresh=score_thresh, class_softmax=class_softmax)
    return finish_winners(out_scores, out_boxes, score_thresh)


fused_decode_nms.launches = 0
fused_decode_nms.global_launches = 0

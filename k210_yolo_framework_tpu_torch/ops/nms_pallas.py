"""Per-class greedy NMS over decoded boxes: the CUDA kernel ``csrc/nms.cu``
and its plain torch version, and the greedy selection loop they share with
the fused head.

Counterpart of ``k210_yolo_framework_tpu/ops/nms_pallas.py``.
``batched_nms_pallas`` dispatches by the device of its input: CPU tensors go
through ``batched_nms_pallas_reference`` (plain torch, whole batch at once);
CUDA tensors through the kernel (one thread block per image and group of
class rows, one warp per row), counted in ``batched_nms_pallas.launches``;
any other device raises.  There
is no fallback from the kernel to the plain version.

``greedy_select_loop`` has the semantics of the JAX package's:

  * each leading-dims row of ``scores`` is one independent NMS problem (one
    (image, class) pair);
  * a step takes the row max (NaN propagates, so a row holding a NaN score
    never selects anything), picks the FIRST index holding it, reads that
    winner's box as ``max(coord, _NEG)`` (the masked-max pick of the TPU
    kernel), and suppresses every candidate with ``IoU > iou_thresh`` plus
    the winner itself;
  * the loop stops once no row's max reaches ``stop_below``.  Winners come
    out in non-increasing order and callers mask slots below the threshold,
    so stopping there never changes what a caller keeps.

The lane padding of the TPU version (``so`` slots rounded up to 128) has no
meaning here: the buffers are exactly ``max_out`` wide.  The CUDA kernels
``csrc/nms.cu`` and ``csrc/yolo_head.cu`` run the same steps
(``csrc/greedy_select.cuh``), one warp per row and G rows of one image a
block; ``greedy_plan`` picks the layout of the rows and G for both:
``shared`` (G > 1) or ``own`` (G == 1) in a block's shared memory, and
``global`` (a scratch tensor, any N) where neither fits.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from k210_yolo_framework_tpu_torch.ops import _build
from k210_yolo_framework_tpu_torch.ops.nms import NmsResult, finish_winners

__all__ = ["batched_nms_pallas", "batched_nms_pallas_reference",
           "global_rows", "greedy_plan", "greedy_select_loop",
           "own_capacity", "rows_per_block"]

_NEG = -1e9


def rows_per_block(batch: int, classes: int, sms: int, footprint,
                   limit: int, max_rows: int) -> int:
    """G, the class rows one block of the greedy kernels runs.  Among the G
    in [1, min(classes, max_rows)] (``max_rows``: the library's limit)
    whose ``footprint(G)`` (the library's, in bytes; it grows with G) fits
    ``limit``, the one that leaves the fewest rows on the busiest of
    ``sms`` SMs when the batch's ``batch * ceil(classes / G)`` blocks
    spread evenly, the largest G on a tie: the fewer blocks, the fewer
    times an image is loaded.  0 when no G fits."""
    best, best_cost = 0, None
    for g in range(1, min(classes, max_rows) + 1):
        if footprint(g) > limit:
            break
        blocks = batch * -(-classes // g)
        cost = -(-blocks // sms) * g
        if best_cost is None or cost <= best_cost:
            best, best_cost = g, cost
    return best


def global_rows(batch: int, classes: int, sms: int, max_rows: int) -> int:
    """G on the global path: ``rows_per_block`` with every G fitting (the
    rows cost no shared memory there)."""
    return rows_per_block(batch, classes, sms, lambda _: 0, 0, max_rows)


def greedy_plan(batch: int, classes: int, sms: int, footprint, limit: int,
                max_rows: int) -> tuple:
    """(layout, G) of a launch of the greedy kernels: ``("shared", G)``
    for G > 1 or ``("own", 1)``, the G of ``rows_per_block`` where some G's
    shared-memory ``footprint(G)`` fits ``limit``; else ``("global",
    global_rows(...))``, the rows in global scratch.  ``footprint(1)`` is
    the ``own`` layout's, so the global path starts where one row's
    candidates no longer fit a block (above 11,622 on an H100)."""
    g = rows_per_block(batch, classes, sms, footprint, limit, max_rows)
    if g:
        return ("shared" if g > 1 else "own"), g
    return "global", global_rows(batch, classes, sms, max_rows)


def own_capacity(footprint, limit: int) -> int:
    """The most candidates whose one-row ``own`` layout
    (``footprint(n, 1)`` bytes) fits ``limit``: ``greedy_plan`` takes the
    global path above it."""
    return _build.largest_fitting(lambda n: footprint(n, 1), limit)


def greedy_select_loop(scores: torch.Tensor, y0: torch.Tensor,
                       x0: torch.Tensor, y1: torch.Tensor, x1: torch.Tensor,
                       max_out: int, iou_thresh: float,
                       stop_below: float | None = None,
                       live: list | None = None):
    """scores [..., N]; box coordinates broadcast against it.  Returns five
    ``[..., max_out]`` winner buffers ``(scores, y0, x0, y1, x1)``: winner k
    in slot k, unfilled slots hold ``_NEG`` score and zero coordinates.

    Where ``live`` is given, each step appends the number of candidates it
    has to test: in the rows still in their loop, those not yet suppressed
    and at or above ``stop_below``."""
    scores = scores.clone()
    n = scores.shape[-1]
    lane = torch.arange(n, device=scores.device).expand(scores.shape)
    zero = torch.zeros((), dtype=scores.dtype, device=scores.device)
    neg = torch.full((), _NEG, dtype=scores.dtype, device=scores.device)
    big = torch.full((), 2 ** 30, dtype=lane.dtype, device=scores.device)
    area = (torch.maximum(y1 - y0, zero) * torch.maximum(x1 - x0, zero))
    stop = _NEG if stop_below is None else stop_below

    out_shape = scores.shape[:-1] + (max_out,)
    bufs = [torch.full(out_shape, _NEG, dtype=scores.dtype,
                       device=scores.device)]
    bufs += [torch.zeros(out_shape, dtype=scores.dtype, device=scores.device)
             for _ in range(4)]

    m = torch.amax(scores, dim=-1, keepdim=True)                  # [..., 1]
    for k in range(max_out):
        # any-row: a NaN row counts as done while healthy rows go on
        if not bool(torch.any(m >= stop)):
            break
        if live is not None:
            live.append(int(((scores >= stop) & (m >= stop)).sum()))
        sel = torch.amin(torch.where(scores == m, lane, big), dim=-1,
                         keepdim=True)
        is_sel = lane == sel

        def pick(row):
            return torch.amax(torch.where(is_sel, row, neg), dim=-1,
                              keepdim=True)

        sy0, sx0, sy1, sx1 = pick(y0), pick(x0), pick(y1), pick(x1)
        s_area = (torch.maximum(sy1 - sy0, zero)
                  * torch.maximum(sx1 - sx0, zero))
        iy = torch.maximum(torch.minimum(sy1, y1) - torch.maximum(sy0, y0),
                           zero)
        ix = torch.maximum(torch.minimum(sx1, x1) - torch.maximum(sx0, x0),
                           zero)
        inter = iy * ix
        union = s_area + area - inter
        iou = torch.where(union > 0, inter / union, zero)
        scores = torch.where((iou > iou_thresh) | is_sel, neg, scores)
        for buf, v in zip(bufs, (m, sy0, sx0, sy1, sx1)):
            buf[..., k:k + 1] = v
        m = torch.amax(scores, dim=-1, keepdim=True)
    return tuple(bufs)


def _select(boxes: torch.Tensor, scores: torch.Tensor, *, max_out: int,
            iou_thresh: float, stop_below: float, live: list | None = None):
    """The kernel's math on plain tensors: boxes [B, N, 4], scores [B, N, C]
    -> winner buffers [B, C, M] and [B, C, M, 4]."""
    y0, x0, y1, x1 = (boxes[:, None, :, i] for i in range(4))     # [B, 1, N]
    w_s, *w_box = greedy_select_loop(scores.transpose(1, 2), y0, x0, y1, x1,
                                     max_out, iou_thresh,
                                     stop_below=stop_below, live=live)
    return w_s, torch.stack(w_box, dim=-1)


def batched_nms_pallas_reference(boxes: torch.Tensor, scores: torch.Tensor,
                                 score_thresh: float = 0.7,
                                 iou_thresh: float = 0.3,
                                 max_out: int = 30) -> NmsResult:
    """Plain-torch version of the NMS kernel, on any device: boxes [B, N, 4]
    yxyx, scores [B, N, C] -> NmsResult [B, C * max_out] (class-major,
    score-descending within a class, the layout of ``ops/nms.batched_nms``).
    """
    w_s, w_b = _select(boxes.to(torch.float32), scores.to(torch.float32),
                       max_out=max_out, iou_thresh=iou_thresh,
                       stop_below=score_thresh)
    return finish_winners(w_s, w_b, score_thresh)


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("nms")
    lib.nms_select.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    lib.nms_select.restype = ctypes.c_int
    lib.nms_error_string.argtypes = [ctypes.c_int]
    lib.nms_error_string.restype = ctypes.c_char_p
    lib.nms_max_dynamic_smem.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.nms_max_dynamic_smem.restype = ctypes.c_int
    for fn in (lib.nms_smem_bytes, lib.nms_scratch_bytes):
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_size_t
    lib.nms_max_rows.argtypes = []
    lib.nms_max_rows.restype = ctypes.c_int
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"nms {what} failed: "
                           + lib.nms_error_string(err).decode())


@functools.cache
def _smem_limit(device: torch.device) -> int:
    """The most dynamic shared memory one block may ask for on ``device``:
    the opt-in limit less the kernel's static shared memory."""
    lib = _kernel_lib()
    nbytes = ctypes.c_int(0)
    with torch.cuda.device(device):
        _check(lib, lib.nms_max_dynamic_smem(ctypes.byref(nbytes)),
               "shared-memory query")
    return nbytes.value


@functools.cache
def _plan(device: torch.device, bsz: int, n: int, classes: int) -> tuple:
    """(layout, G) for a launch of this shape (``greedy_plan``)."""
    lib = _kernel_lib()
    return greedy_plan(
        bsz, classes, torch.cuda.get_device_properties(device)
        .multi_processor_count, lambda g: lib.nms_smem_bytes(n, g),
        _smem_limit(device), lib.nms_max_rows())


def _launch(boxes: torch.Tensor, scores: torch.Tensor, *, max_out: int,
            iou_thresh: float, score_thresh: float, rows: int | None = None,
            layout: str | None = None):
    """Run ``csrc/nms.cu`` on the current stream; returns the winner
    buffers [B, C, M] and [B, C, M, 4].  ``rows`` class rows a block and
    their ``layout`` default to ``_plan``'s; a forced ``rows`` must fit
    shared memory unless ``layout`` is ``"global"``, which runs the global
    path at any N (default G: ``global_rows``)."""
    bsz, n, classes = scores.shape
    for name, t in (("boxes", boxes), ("scores", scores)):
        if t.device != scores.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous float32 tensor on "
                             f"{scores.device}, got {t.dtype} on {t.device}")
    if boxes.shape != (bsz, n, 4):
        raise ValueError(f"shape mismatch: boxes {tuple(boxes.shape)}, "
                         f"scores {tuple(scores.shape)}")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes: the kernel reads each box as one 16-byte "
                         "vector and needs a 16-byte aligned tensor")
    if layout not in (None, "global"):
        raise ValueError(f"layout {layout!r}: None (planned) or 'global'")
    out_scores = torch.empty((bsz, classes, max_out), dtype=torch.float32,
                             device=scores.device)
    out_boxes = torch.empty((bsz, classes, max_out, 4), dtype=torch.float32,
                            device=scores.device)
    if bsz == 0 or classes == 0 or max_out == 0:
        return out_scores, out_boxes
    lib = _kernel_lib()
    if layout == "global":
        if rows is None:
            rows = global_rows(bsz, classes, torch.cuda.get_device_properties(
                scores.device).multi_processor_count, lib.nms_max_rows())
        elif not 1 <= rows <= lib.nms_max_rows():
            raise ValueError(f"{rows} class rows a block: 1 to "
                             f"{lib.nms_max_rows()}")
    elif rows is None:
        layout, rows = _plan(scores.device, bsz, n, classes)
    elif not 1 <= rows <= lib.nms_max_rows() or \
            lib.nms_smem_bytes(n, rows) > _smem_limit(scores.device):
        raise ValueError(f"{rows} class rows a block of {n} candidates do "
                         f"not fit one block's shared memory (1 to "
                         f"{lib.nms_max_rows()} rows)")
    scratch = None
    if layout == "global":
        blocks = bsz * -(-classes // rows)
        scratch = torch.empty(blocks * lib.nms_scratch_bytes(n, rows) // 4,
                              dtype=torch.float32, device=scores.device)
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        err = lib.nms_select(boxes.data_ptr(), scores.data_ptr(),
                             out_scores.data_ptr(), out_boxes.data_ptr(),
                             None if scratch is None else scratch.data_ptr(),
                             bsz, n, classes, rows, max_out, iou_thresh,
                             score_thresh, stream)
    _check(lib, err, "kernel launch")
    batched_nms_pallas.launches += 1
    if scratch is not None:
        batched_nms_pallas.global_launches += 1
    return out_scores, out_boxes


def batched_nms_pallas(boxes: torch.Tensor, scores: torch.Tensor,
                       score_thresh: float = 0.7, iou_thresh: float = 0.3,
                       max_out: int = 30) -> NmsResult:
    """boxes [B, N, 4] yxyx, scores [B, N, C] -> NmsResult [B, C * max_out].

    CPU tensors go through ``batched_nms_pallas_reference``; CUDA tensors
    through the kernel at any N, counted in ``batched_nms_pallas.launches``
    (and those on the global path also in ``.global_launches``)."""
    device = scores.device
    if device.type == "cpu":
        return batched_nms_pallas_reference(boxes, scores, score_thresh,
                                            iou_thresh, max_out)
    if device.type != "cuda":
        raise ValueError(f"batched_nms_pallas: no kernel for device {device}")
    out_scores, out_boxes = _launch(
        boxes.to(torch.float32).contiguous(),
        scores.to(torch.float32).contiguous(), max_out=max_out,
        iou_thresh=iou_thresh, score_thresh=score_thresh)
    return finish_winners(out_scores, out_boxes, score_thresh)


batched_nms_pallas.launches = 0
batched_nms_pallas.global_launches = 0

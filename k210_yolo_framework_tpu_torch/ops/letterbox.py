"""Letterbox resize (aspect-preserving scale + centred pad), batched.

Counterpart of ``k210_yolo_framework_tpu/ops/letterbox.py``.  The JAX
version builds its two separable resample matrices with JAX's private
``compute_weight_mat`` (triangle kernel, no antialias); ``weight_mat`` below
rebuilds that function line for line, because ``F.interpolate`` uses other
pixel-centre and normalisation rules and does not match.  The resample is
then two small matrix products per image, batched over per-image sizes.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["letterbox_params", "weight_mat", "letterbox_image",
           "letterbox_stem_patches", "letterbox_boxes", "correct_boxes",
           "normalize_image", "normalize_images"]


@functools.lru_cache(maxsize=16)
def _cached_const(values: Tuple[float, ...],
                  device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def _const(values: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """A small fp32 constant on ``device``, copied there once: a fresh
    host-to-device copy on every call would wait for the device's queue.
    Under ``torch.export`` (or ``torch.compile``) it is made afresh: the
    tracer's tensors must not reach the cache."""
    if torch.compiler.is_compiling():
        return _cached_const.__wrapped__(values, device)
    return _cached_const(values, device)


def letterbox_params(img_hws: torch.Tensor, in_hw: Tuple[int, int]):
    """Scale and integer (x, y) translation for images of size ``img_hws``
    ([..., 2] as (h, w)); returns ``scale [...]`` and ``translation
    [..., 2]``.  The translation is truncated toward zero, as the
    reference's ``astype(int)`` does."""
    img_wh = img_hws.flip(-1).to(torch.float32)
    in_wh = _const((float(in_hw[1]), float(in_hw[0])), img_hws.device)
    scale = torch.amin(in_wh / img_wh, dim=-1)
    translation = torch.trunc((in_wh - img_wh * scale[..., None]) / 2.0)
    return scale, translation


def weight_mat(input_size: int, output_size: int, scale: torch.Tensor,
               translation: torch.Tensor) -> torch.Tensor:
    """[B, input_size, output_size] fp32 bilinear resample weights, one
    matrix per image from ``scale [B]`` and ``translation [B]`` (pixel-centre
    convention of ``jax.image.scale_and_translate``)."""
    inv_scale = 1.0 / scale[:, None]
    out_pos = torch.arange(output_size, dtype=torch.float32,
                           device=scale.device)
    sample_f = ((out_pos + 0.5) * inv_scale
                - translation[:, None] * inv_scale - 0.5)         # [B, out]
    in_pos = torch.arange(input_size, dtype=torch.float32,
                          device=scale.device)
    x = torch.abs(sample_f[:, None, :] - in_pos[None, :, None])   # [B, in, out]
    weights = torch.clamp_min(1.0 - x, 0.0)
    total = torch.sum(weights, dim=1, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    weights = torch.where(
        torch.abs(total) > eps,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    # zero the columns whose sample lies wholly outside the input
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return torch.where(inside[:, None, :], weights, torch.zeros_like(weights))


def letterbox_image(canvases: torch.Tensor, img_hws: torch.Tensor,
                    in_hw: Tuple[int, int],
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Letterbox a batch of canvases [B, H, W, C] (any real dtype) into
    [B, in_h, in_w, C] of ``dtype``.

    Each canvas holds its real image in the top-left ``img_hws[b]`` region,
    zeros elsewhere; the resample reads the whole canvas, as the JAX version
    does.  Sampling positions are always computed in fp32; ``dtype`` sets
    the dtype of the pixel products.  The result is truncated and clipped to
    0..255 like the reference's uint8 store."""
    scale, translation = letterbox_params(img_hws, in_hw)
    # skimage pixel-centre convention -> scale_and_translate convention
    adj = 0.5 * (1.0 - scale)
    ty, tx = translation[:, 1] + adj, translation[:, 0] + adj
    w_h = weight_mat(canvases.shape[1], in_hw[0], scale, ty).to(dtype)
    w_w = weight_mat(canvases.shape[2], in_hw[1], scale, tx).to(dtype)
    out = torch.einsum("bhwc,bhi,bwj->bijc", canvases.to(dtype), w_h, w_w)
    out = torch.clamp(torch.trunc(out.to(torch.float32)), 0.0, 255.0)
    return out.to(dtype).contiguous()


def _tap_columns(w: torch.Tensor, n_in: int, n_out: int, k: int, s: int,
                 p: int) -> torch.Tensor:
    """[B, src, n_in] resample weights -> [B, src, n_out * k]: column
    (i, dy) is the canvas column ``s * i + dy - p``, or zeros where that tap
    lands in the conv's zero padding."""
    wp = F.pad(w, (p, max(0, s * (n_out - 1) + k - p - n_in)))
    taps = [wp[:, :, dy::s][:, :, :n_out] for dy in range(k)]
    return torch.stack(taps, dim=-1).reshape(w.shape[0], w.shape[1],
                                             n_out * k)


def letterbox_stem_patches(canvases: torch.Tensor, img_hws: torch.Tensor,
                           in_hw: Tuple[int, int], *,
                           kernel: Tuple[int, int] = (3, 3),
                           stride: Tuple[int, int] = (2, 2),
                           pad: Tuple[int, int] = (1, 1),
                           dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """Letterbox a batch of canvases and emit the stem conv's im2col
    patches directly: [B, Ho, kh, Wo, kw, C] of ``dtype``, where
    ``out[b, i, dy, j, dx, c]`` is the zero-padded letterboxed canvas
    ``letterbox_image(...)[b]`` at ``(sh * i + dy - ph, sw * j + dx - pw,
    c)``.  The two resample matrices of ``letterbox_image`` get their
    columns re-indexed (``_tap_columns``), so the canvas is never made.

    The contraction runs over the canvas rows first, then its columns: the
    order ``letterbox_image``'s einsum takes at the served shapes, so each
    tap equals the canvas pixel bit for bit there.  (Left to torch's
    einsum with opt_einsum, this equation's three operands would take the
    other order at 240x320 canvases, and some taps would land a level off,
    many of them in bf16.)"""
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, pad
    ho = (in_hw[0] + 2 * ph - kh) // sh + 1
    wo = (in_hw[1] + 2 * pw - kw) // sw + 1
    scale, translation = letterbox_params(img_hws, in_hw)
    adj = 0.5 * (1.0 - scale)
    ty, tx = translation[:, 1] + adj, translation[:, 0] + adj
    w_h = _tap_columns(weight_mat(canvases.shape[1], in_hw[0], scale, ty),
                       in_hw[0], ho, kh, sh, ph).to(dtype)
    w_w = _tap_columns(weight_mat(canvases.shape[2], in_hw[1], scale, tx),
                       in_hw[1], wo, kw, sw, pw).to(dtype)
    rows = torch.einsum("bhwc,bhp->bwcp", canvases.to(dtype), w_h)
    out = torch.einsum("bwcp,bwq->bpqc", rows, w_w)
    out = torch.clamp(torch.trunc(out.to(torch.float32)), 0.0, 255.0)
    return out.to(dtype).reshape(canvases.shape[0], ho, kh, wo, kw,
                                 canvases.shape[-1])


def letterbox_boxes(boxes: torch.Tensor, img_hws: torch.Tensor,
                    in_hw: Tuple[int, int]) -> torch.Tensor:
    """Move boxes [B, N, 5] (class, x, y, w, h), normalised to each original
    image ``img_hws [B, 2]``, through that image's letterbox affine."""
    img_wh = img_hws.flip(-1).to(torch.float32)[:, None, :]         # [B, 1, 2]
    in_wh = _const((float(in_hw[1]), float(in_hw[0])), boxes.device)
    scale, translation = letterbox_params(img_hws, in_hw)
    scale = scale[:, None, None]
    xy = (boxes[..., 1:3] * img_wh * scale + translation[:, None, :]) / in_wh
    wh = boxes[..., 3:5] * img_wh * scale / in_wh
    return torch.cat([boxes[..., 0:1], xy, wh], dim=-1)


def correct_boxes(box_xy: torch.Tensor, box_wh: torch.Tensor,
                  in_hw: Tuple[int, int],
                  image_hws: torch.Tensor) -> torch.Tensor:
    """Undo the letterbox: normalised net-scale xy / wh [B, ..., 2] ->
    original-image yxyx pixels [B, ..., 4], for images of size
    ``image_hws [B, 2]``.  Like the reference's ``correct_box`` it
    recomputes the pad with ``round`` (half to even) rather than the
    forward's truncation; extents clamp at 1."""
    box_yx = box_xy.flip(-1)
    box_hw = box_wh.flip(-1)
    input_shape = _const((float(in_hw[0]), float(in_hw[1])), box_xy.device)
    image_shape = image_hws.to(torch.float32)                       # [B, 2]
    new_shape = torch.clamp_min(torch.round(image_shape * torch.amin(
        input_shape / image_shape, dim=-1, keepdim=True)), 1.0)
    lead = (image_shape.shape[0],) + (1,) * (box_xy.ndim - 2) + (2,)
    offset = ((input_shape - new_shape) / 2.0 / input_shape).reshape(lead)
    scale = (input_shape / new_shape).reshape(lead)
    box_yx = (box_yx - offset) * scale
    box_hw = box_hw * scale
    boxes = torch.cat([box_yx - box_hw / 2.0, box_yx + box_hw / 2.0], dim=-1)
    return boxes * torch.cat([image_shape, image_shape], -1).reshape(
        lead[:-1] + (4,))


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """``img / max(img)`` over the whole tensor (not /255), as the
    reference normalises one image."""
    return img / torch.clamp_min(torch.amax(img), 1e-12)


def normalize_images(imgs: torch.Tensor) -> torch.Tensor:
    """``normalize_image`` of each image of a batch [B, H, W, C], in the
    batch's dtype."""
    peak = torch.amax(imgs, dim=tuple(range(1, imgs.ndim)), keepdim=True)
    return imgs / torch.clamp_min(peak, 1e-12)

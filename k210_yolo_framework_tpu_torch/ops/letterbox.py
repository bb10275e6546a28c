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

__all__ = ["letterbox_params", "weight_mat", "letterbox_image",
           "normalize_image"]


@functools.lru_cache(maxsize=16)
def _const(values: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """A small fp32 constant on ``device``, copied there once: a fresh
    host-to-device copy on every call would wait for the device's queue."""
    return torch.tensor(values, dtype=torch.float32, device=device)


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


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """``img / max(img)`` over the whole tensor (not /255), as the
    reference normalises one image."""
    return img / torch.clamp_min(torch.amax(img), 1e-12)

"""Training augmentation: OneOf{fliplr, rotate, translate}, batched.

Counterpart of ``k210_yolo_framework_tpu/ops/augment.py``
(``_translate_bilinear``, ``_flip_params`` / ``_rot_params`` /
``_tr_params``, ``_affine_boxes``, ``augment_batch``,
``augment_image_and_boxes``).  The reference's
imgaug pipeline: one branch per image, Fliplr(0.5), Affine(rotate U(-10,
10) degrees) or Affine(translate_percent U(-0.1, 0.1) per axis); the boxes
ride the same affine (corners moved, re-boxed, clipped, and marked invalid
when they leave the image or become empty).

Random draws are made on the host from a CPU ``torch.Generator`` (the
permutation, the flip bits, the thetas and the translations), so the card
and the CPU see the same augment for the same seed.  They can also be
handed in ready-made as :class:`AugmentParams`: torch cannot replay
``jax.random``, so the parity tests rebuild JAX's draws and inject them.

``mode="stratified"`` (default) splits a random permutation of the batch
into ceil(B/3) flip, floor(B/3) rotate and floor(B/3) translate slots, in
that order, and returns the batch in permuted order; ``mode="iid"`` (and any
batch under 3) draws a branch per image.  The rotation is the hand-written
kernel of ``ops/rotate_pallas.py``, which accumulates in fp32 whatever the
image dtype; flip and translate run in the image dtype, as in the JAX
package.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from k210_yolo_framework_tpu_torch.ops.letterbox import _const
from k210_yolo_framework_tpu_torch.ops.rotate_pallas import (
    MAX_ROT_DEG,
    rotate_3shear,
)

__all__ = ["MAX_ROT_DEG", "MAX_TRANSLATE", "AugmentParams", "draw_params",
           "augment_batch", "augment_image_and_boxes", "translate_bilinear",
           "affine_boxes"]

MAX_TRANSLATE = 0.1    # reference: Affine(translate_percent=+-0.1)
FLIP, ROTATE, TRANSLATE = 0, 1, 2


class AugmentParams(NamedTuple):
    """One batch's draws, all [B] on the CPU.  ``perm`` (int64) is the
    stratified permutation (identity for iid); ``branch`` (int64) the branch
    of each slot after the permutation; ``do_flip`` (bool); ``theta``
    (float32 radians); ``tx``/``ty`` (float32 pixels)."""

    perm: torch.Tensor
    branch: torch.Tensor
    do_flip: torch.Tensor
    theta: torch.Tensor
    tx: torch.Tensor
    ty: torch.Tensor


def _split(b: int) -> Tuple[int, int]:
    """(end of the flip slots, end of the rotate slots) of a stratified
    batch: ceil(B/3) flip, floor(B/3) rotate, floor(B/3) translate."""
    n_flip = b - 2 * (b // 3)
    return n_flip, n_flip + b // 3


def draw_params(b: int, img_hw: Tuple[int, int], mode: str = "stratified",
                generator: Optional[torch.Generator] = None) -> AugmentParams:
    """Draw a batch's augment on the host from ``generator``."""
    h, w = img_hw

    def uniform(lo, hi):
        return torch.rand(b, generator=generator) * (hi - lo) + lo

    if mode == "stratified" and b >= 3:
        perm = torch.randperm(b, generator=generator)
        lo, mid = _split(b)
        branch = torch.full((b,), TRANSLATE, dtype=torch.int64)
        branch[:lo], branch[lo:mid] = FLIP, ROTATE
    elif mode in ("iid", "stratified"):
        perm = torch.arange(b)
        branch = torch.randint(0, 3, (b,), generator=generator)
    else:
        raise ValueError(f"unknown augment mode {mode!r} (iid|stratified)")
    do_flip = torch.rand(b, generator=generator) < 0.5
    theta = torch.deg2rad(uniform(-MAX_ROT_DEG, MAX_ROT_DEG))
    tx = uniform(-MAX_TRANSLATE, MAX_TRANSLATE) * w
    ty = uniform(-MAX_TRANSLATE, MAX_TRANSLATE) * h
    return AugmentParams(perm, branch, do_flip, theta, tx, ty)


def _matrices(p: AugmentParams, img_hw: Tuple[int, int]) -> torch.Tensor:
    """[B, 3, 3] forward affine of each slot's branch, in continuous image
    coordinates (pixel i spans [i, i + 1)): a mirror is x' = w - x and the
    rotation pivots on (w/2, h/2)."""
    h, w = img_hw
    b = p.branch.shape[0]
    m = torch.eye(3).repeat(b, 1, 1)
    flip = (p.branch == FLIP) & p.do_flip
    m[flip, 0, 0] = -1.0
    m[flip, 0, 2] = float(w)
    rot = p.branch == ROTATE
    c, s = torch.cos(p.theta), torch.sin(p.theta)
    cx, cy = w / 2.0, h / 2.0
    rows = torch.stack([
        torch.stack([c, -s, cx - c * cx + s * cy], -1),
        torch.stack([s, c, cy - s * cx - c * cy], -1)], 1)          # [B, 2, 3]
    m[rot, :2] = rows[rot]
    tr = p.branch == TRANSLATE
    m[tr, 0, 2] = p.tx[tr]
    m[tr, 1, 2] = p.ty[tr]
    return m


def affine_boxes(boxes: torch.Tensor, valid: torch.Tensor, fwd: torch.Tensor,
                 img_hw: Tuple[int, int]):
    """Move boxes [B, N, 5] (class, x, y, w, h, normalised) through ``fwd``
    [B, 3, 3]: the 4 corners are transformed, re-boxed axis-aligned, clipped
    to the image, and marked invalid when fully outside or empty."""
    h, w = img_hw
    scale = _const((float(w), float(h)), boxes.device)
    xy = boxes[..., 1:3] * scale
    half = boxes[..., 3:5] * scale / 2.0
    signs = _const((-1.0, -1.0, 1.0, -1.0, -1.0, 1.0, 1.0, 1.0),
                   boxes.device).reshape(4, 2)
    corners = xy[..., None, :] + signs * half[..., None, :]        # [B, N, 4, 2]
    cx, cy = corners[..., 0], corners[..., 1]
    f = fwd[:, None, None]                                         # [B, 1, 1, 3, 3]
    moved = torch.stack(
        [f[..., 0, 0] * cx + f[..., 0, 1] * cy + f[..., 0, 2],
         f[..., 1, 0] * cx + f[..., 1, 1] * cy + f[..., 1, 2]], dim=-1)
    mins = moved.amin(dim=-2)
    maxes = moved.amax(dim=-2)
    inside = (maxes[..., 0] > 0) & (maxes[..., 1] > 0) \
        & (mins[..., 0] < w) & (mins[..., 1] < h)
    zero = scale.new_zeros(2)
    mins = torch.clamp(mins, zero, scale)
    maxes = torch.clamp(maxes, zero, scale)
    new_xy = (mins + maxes) / 2.0 / scale
    new_wh = (maxes - mins) / scale
    nonempty = (new_wh[..., 0] > 0) & (new_wh[..., 1] > 0)
    out = torch.cat([boxes[..., 0:1], new_xy, new_wh], dim=-1)
    return out, valid & inside & nonempty


def translate_bilinear(imgs: torch.Tensor, tx: torch.Tensor,
                       ty: torch.Tensor) -> torch.Tensor:
    """``out[b, y, x] = img[b, y - ty[b], x - tx[b]]`` for continuous shifts
    |tx| <= 0.1 w, |ty| <= 0.1 h: four taps of the zero-padded image and a
    lerp, in the image dtype."""
    n, h, w, _ = imgs.shape
    mx = math.ceil(MAX_TRANSLATE * w) + 1
    my = math.ceil(MAX_TRANSLATE * h) + 1
    kx, ky = torch.floor(tx), torch.floor(ty)
    fx = (tx - kx).to(imgs.dtype)[:, None, None, None]
    fy = (ty - ky).to(imgs.dtype)[:, None, None, None]
    kx, ky = kx.to(torch.int64), ky.to(torch.int64)
    padded = torch.nn.functional.pad(imgs, (0, 0, mx, mx, my, my))
    bi = torch.arange(n, device=imgs.device)[:, None, None]
    rows = torch.arange(h, device=imgs.device)[None, :] + my - ky[:, None]
    cols = torch.arange(w, device=imgs.device)[None, :] + mx - kx[:, None]

    def tap(dy, dx):
        return padded[bi, (rows - dy)[:, :, None], (cols - dx)[:, None, :]]

    top = tap(0, 0) * (1 - fx) + tap(0, 1) * fx
    bot = tap(1, 0) * (1 - fx) + tap(1, 1) * fx
    return top * (1 - fy) + bot * fy


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device``; to a GPU through pinned memory without
    waiting, so the host does not stall on the device's queue."""
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def augment_batch(imgs: torch.Tensor, boxes: torch.Tensor,
                  valid: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  params: Optional[AugmentParams] = None,
                  mode: str = "stratified"):
    """imgs [B, H, W, C] (float, or uint8 promoted to float32), boxes
    [B, N, 5], valid [B, N] -> the augmented (imgs, boxes, valid), in the
    order of ``params.perm``.  ``params`` (drawn with
    :func:`draw_params`) overrides ``generator`` and ``mode``.  The draws
    reach the device in two copies."""
    b, h, w = imgs.shape[0], imgs.shape[1], imgs.shape[2]
    if params is None:
        params = draw_params(b, (h, w), mode, generator)
    if not imgs.is_floating_point():
        imgs = imgs.to(torch.float32)
    device = imgs.device
    flip_i = torch.nonzero((params.branch == FLIP) & params.do_flip).flatten()
    rot_i = torch.nonzero(params.branch == ROTATE).flatten()
    tr_i = torch.nonzero(params.branch == TRANSLATE).flatten()
    ints = _to_device(torch.cat([params.perm, flip_i, rot_i, tr_i]), device)
    floats = _to_device(torch.cat([
        params.theta[rot_i], params.tx[tr_i], params.ty[tr_i],
        _matrices(params, (h, w)).flatten()]), device)
    perm, flip_i, rot_i, tr_i = ints.split(
        [b, len(flip_i), len(rot_i), len(tr_i)])
    theta, tx, ty, mats = floats.split(
        [len(rot_i), len(tr_i), len(tr_i), 9 * b])

    imgs = imgs.index_select(0, perm)
    out = imgs.clone()
    if len(flip_i):
        out[flip_i] = imgs[flip_i].flip(2)
    if len(rot_i):
        out[rot_i] = rotate_3shear(imgs[rot_i], theta)
    if len(tr_i):
        out[tr_i] = translate_bilinear(imgs[tr_i], tx, ty)
    boxes, valid = affine_boxes(boxes.index_select(0, perm),
                                valid.index_select(0, perm),
                                mats.reshape(b, 3, 3), (h, w))
    return out, boxes, valid


def augment_image_and_boxes(img: torch.Tensor, boxes: torch.Tensor,
                            valid: torch.Tensor,
                            generator: Optional[torch.Generator] = None,
                            params: Optional[AugmentParams] = None):
    """One image [H, W, C], its boxes [N, 5] and valid [N] -> the augmented
    (img, boxes, valid): :func:`augment_batch` on a batch of one (a branch
    drawn for the image; a CUDA image's rotation is the rotation
    kernel)."""
    out, boxes, valid = augment_batch(img[None], boxes[None], valid[None],
                                      generator=generator, params=params,
                                      mode="iid")
    return out[0], boxes[0], valid[0]

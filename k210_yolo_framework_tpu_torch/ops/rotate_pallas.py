"""The augment's 3-shear rotation: plain torch and a hand-written CUDA kernel.

Counterpart of ``k210_yolo_framework_tpu/ops/rotate_pallas.py``
(``_frame_geometry``, ``rotate_3shear_pallas``).  A centre rotation by
``theta`` (|theta| <= 10 degrees) is the Paeth composition
Sx(a) . Sy(b) . Sx(a) with a = -tan(theta / 2), b = sin(theta).  Each pass
shifts every line of a zero-padded working frame by a per-line continuous
offset with a two-tap linear blend; the result is cropped back.

Numerics follow the TPU kernel, not the slice-sum path
(``augment._rotate_3shear``): per line, k = floor(offset) and f = offset - k
with f and 1 - f rounded to the image dtype, then every pass computes
``(1 - f) * src[x - k] + f * src[x - k - 1]`` in fp32 (zeros outside the
frame), and the crop is cast to the image dtype once.  The TPU kernel's
slice sum has only these two nonzero terms per output, so the two agree.

``rotate_3shear`` dispatches by device: CPU tensors go through
``rotate_3shear_reference``; CUDA tensors through ``csrc/rotate3shear.cu``
or it raises.  Both take the same per-line tables from ``shear_tables``,
computed once in torch fp32, so a CUDA ``tanf`` cannot split them.  The
kernel runs the three passes in one launch, a block per output tile with
the pass-1 values its outputs reach in shared memory; ``plan_tile`` sizes
the tile from the frame and the device's shared-memory limit
(``smem_bytes``), so no fp32 frame is ever written to device memory.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from k210_yolo_framework_tpu_torch.ops import _build

__all__ = ["MAX_ROT_DEG", "ShearTables", "Tile", "frame_geometry",
           "plan_tile", "rotate_3shear", "rotate_3shear_reference",
           "shear_tables", "smem_bytes", "staged_columns"]

MAX_ROT_DEG = 10.0  # reference: Affine(rotate=(-10, 10))


def frame_geometry(h: int, w: int) -> Tuple[int, int, int, int, int, int]:
    """(px, py, hp, wp, xb, yb): the working frame's pads and size, and the
    passes' offset bounds for |theta| <= MAX_ROT_DEG, as the JAX package
    computes them."""
    amax = math.tan(math.radians(MAX_ROT_DEG) / 2.0)
    bmax = math.sin(math.radians(MAX_ROT_DEG))
    px = int(math.ceil(amax * (h / 2.0))) + 2
    py = int(math.ceil(bmax * (w / 2.0 + px))) + 2
    hp, wp = h + 2 * py, w + 2 * px
    xb = int(math.ceil(amax * (hp / 2.0))) + 1
    yb = int(math.ceil(bmax * (wp / 2.0))) + 1
    return px, py, hp, wp, xb, yb


class ShearTables(NamedTuple):
    """Per-line two-tap tables of the passes: ``kx``/``wx0``/``wx1`` [N, hp]
    for the x-shears (one entry per frame row), ``ky``/``wy0``/``wy1``
    [N, wp] for the y-shear (one per frame column).  ``k*`` int32 floor of
    the offset; ``w*0`` = 1 - f and ``w*1`` = f, rounded to the image dtype
    and widened to fp32."""

    kx: torch.Tensor
    wx0: torch.Tensor
    wx1: torch.Tensor
    ky: torch.Tensor
    wy0: torch.Tensor
    wy1: torch.Tensor


def _two_tap(offs: torch.Tensor, dtype: torch.dtype):
    k = torch.floor(offs)
    f = (offs - k).to(dtype)
    return (k.to(torch.int32).contiguous(), (1 - f).to(torch.float32),
            f.to(torch.float32))


def shear_tables(thetas: torch.Tensor, h: int, w: int,
                 dtype: torch.dtype) -> ShearTables:
    """Tables for rotating [N, h, w, C] images of ``dtype`` by ``thetas``
    [N] (radians), on the device of ``thetas``.  The offsets pivot on the
    original image centre: a * ys over the frame's rows, b * xs over its
    columns."""
    px, py, hp, wp, _, _ = frame_geometry(h, w)
    thetas = thetas.to(torch.float32)
    a = -torch.tan(thetas / 2.0)
    b = torch.sin(thetas)
    ys = torch.arange(hp, dtype=torch.float32, device=thetas.device) \
        + 0.5 - (py + h / 2.0)
    xs = torch.arange(wp, dtype=torch.float32, device=thetas.device) \
        + 0.5 - (px + w / 2.0)
    return ShearTables(*_two_tap(a[:, None] * ys[None, :], dtype),
                       *_two_tap(b[:, None] * xs[None, :], dtype))


def _shift_rows(src: torch.Tensor, k: torch.Tensor, w0: torch.Tensor,
                w1: torch.Tensor) -> torch.Tensor:
    """out[n, y, x] = w0[n, y] * src[n, y, x - k] + w1[n, y] * src[n, y,
    x - k - 1], with k = k[n, y] and zeros outside; src [N, H, W, C] fp32."""
    n, rows, cols, ch = src.shape
    j0 = torch.arange(cols, device=src.device)[None, None, :] \
        - k.to(torch.int64)[:, :, None]                             # [N, H, W]

    def tap(j):
        inside = (j >= 0) & (j < cols)
        idx = j.clamp(0, cols - 1)[..., None].expand(n, rows, cols, ch)
        return torch.where(inside[..., None], torch.gather(src, 2, idx),
                           src.new_zeros(()))

    return w0[:, :, None, None] * tap(j0) + w1[:, :, None, None] * tap(j0 - 1)


def _rotate_plain(imgs: torch.Tensor, t: ShearTables) -> torch.Tensor:
    """The kernel's arithmetic on plain tensors, over the whole batch."""
    _, h, w, _ = imgs.shape
    px, py, _, _, _, _ = frame_geometry(h, w)
    frame = F.pad(imgs.to(torch.float32), (0, 0, px, px, py, py))
    out = _shift_rows(frame, t.kx, t.wx0, t.wx1)                    # Sx
    out = _shift_rows(out.transpose(1, 2), t.ky, t.wy0,
                      t.wy1).transpose(1, 2)                        # Sy
    out = _shift_rows(out[:, py:py + h], t.kx[:, py:py + h],        # Sx, crop
                      t.wx0[:, py:py + h], t.wx1[:, py:py + h])
    return out[:, :, px:px + w].to(imgs.dtype)


def _check_images(imgs: torch.Tensor, thetas: torch.Tensor) -> None:
    if imgs.ndim != 4 or thetas.shape != (imgs.shape[0],):
        raise ValueError(f"need imgs [N, H, W, C] and thetas [N], got "
                         f"{tuple(imgs.shape)} and {tuple(thetas.shape)}")
    if imgs.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"imgs: need float32 or bfloat16, got {imgs.dtype}")


def rotate_3shear_reference(imgs: torch.Tensor,
                            thetas: torch.Tensor) -> torch.Tensor:
    """Plain-torch rotation of imgs [N, H, W, C] (float32 or bfloat16) by
    ``thetas`` [N] radians, on any device; same shape and dtype out."""
    _check_images(imgs, thetas)
    return _rotate_plain(imgs, shear_tables(thetas.to(imgs.device),
                                            imgs.shape[1], imgs.shape[2],
                                            imgs.dtype))


# Resident blocks an SM the tile search plans for, as the kernel's launch
# bounds do: the kernel waits on memory, and three blocks of 16 warps an SM
# measured faster than two (H100).
BLOCKS_PER_SM = 3
# the most the x offsets of consecutive frame rows move apart a row
_AMAX = math.tan(math.radians(MAX_ROT_DEG) / 2.0)
# the search's fixed cost of a block, in staged values: its tables, its
# barriers and its offsets' reduction
_BLOCK_COST = 2048


class Tile(NamedTuple):
    """A launch's tiling: ``rows`` x ``cols`` outputs a block, ``staged``
    pass-2 columns of the frame held in its shared memory."""

    rows: int
    cols: int
    staged: int


def staged_columns(rows: int, cols: int, wp: int) -> int:
    """Pass-2 columns a block of ``rows`` x ``cols`` outputs stages: its
    columns, one more for the second tap, and the x offsets' spread over
    ``rows`` frame rows at |theta| <= MAX_ROT_DEG (one more for rounding);
    at most the frame's ``wp``."""
    return min(cols + math.ceil(_AMAX * (rows - 1)) + 2, wp)


def smem_bytes(rows: int, staged: int, c: int, hp: int) -> int:
    """Dynamic shared memory of a block (``rotate3shear_smem_bytes``): the
    fp32 pass-2 values, rows x staged x c, and the x tables of the frame's
    ``hp`` rows (3 x hp)."""
    return 4 * (rows * staged * c + 3 * hp)


@functools.lru_cache(maxsize=256)
def plan_tile(h: int, w: int, c: int, limit: int) -> Tile:
    """The tile of an [h, w, c] image whose block needs at most ``limit``
    bytes of shared memory and stages the fewest pass-1 values per image
    (a block's fixed cost counted as ``_BLOCK_COST`` values): for each row
    count up to h, the widest tile that fits, then the image cut into
    equal tiles no larger than it.  Raises ValueError when not even one
    output a block fits."""
    _, _, hp, wp, _, _ = frame_geometry(h, w)
    best = None
    for tr0 in sorted({min(h, 1 << k) for k in range(h.bit_length())} | {h}):
        tc0 = _build.largest_fitting(
            lambda tc: smem_bytes(tr0, staged_columns(tr0, tc, wp), c, hp),
            limit, hi=w)
        if tc0 == 0:
            continue
        ny, nx = -(-h // tr0), -(-w // tc0)
        tr, tc = -(-h // ny), -(-w // nx)
        staged = staged_columns(tr, tc, wp)
        cost = ny * nx * (_BLOCK_COST + (tr + 1) * staged * c)
        if best is None or cost < best[0]:
            best = (cost, Tile(tr, tc, staged))
    if best is None:
        raise ValueError(f"no tile of a [{h}, {w}, {c}] image fits "
                         f"{limit} bytes of shared memory")
    return best[1]


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("rotate3shear")
    lib.rotate3shear.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    lib.rotate3shear.restype = ctypes.c_int
    lib.rotate3shear_error_string.argtypes = [ctypes.c_int]
    lib.rotate3shear_error_string.restype = ctypes.c_char_p
    lib.rotate3shear_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.rotate3shear_smem_bytes.restype = ctypes.c_size_t
    lib.rotate3shear_max_dynamic_smem.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.rotate3shear_max_dynamic_smem.restype = ctypes.c_int
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"rotate3shear {what} failed: "
                           + lib.rotate3shear_error_string(err).decode())


@functools.cache
def smem_limit(device: torch.device, blocks_per_sm: int = BLOCKS_PER_SM
               ) -> int:
    """The most dynamic shared memory a block may ask for on ``device``
    while ``blocks_per_sm`` blocks share an SM."""
    lib = _kernel_lib()
    nbytes = ctypes.c_int(0)
    with torch.cuda.device(device):
        _check(lib, lib.rotate3shear_max_dynamic_smem(
            blocks_per_sm, ctypes.byref(nbytes)), "shared-memory query")
    return nbytes.value


def _check_launch(imgs: torch.Tensor, t: ShearTables) -> None:
    """What the kernel takes: a contiguous float32 / bfloat16 image whose
    frame indexes in 32 bits, and contiguous per-line tables of [N, hp] /
    [N, wp] on its device."""
    n, h, w, c = imgs.shape
    _, _, hp, wp, _, _ = frame_geometry(h, w)
    if not imgs.is_contiguous() or imgs.dtype not in (torch.float32,
                                                      torch.bfloat16):
        raise ValueError(f"imgs: need a contiguous float32 or bfloat16 "
                         f"tensor, got {imgs.dtype}")
    if hp * wp * c >= 2 ** 31:
        raise ValueError(f"a {h}x{w}x{c} image's frame ({hp}x{wp}) does not "
                         f"index in 32 bits")
    for name, tab, lines in (("kx", t.kx, hp), ("wx0", t.wx0, hp),
                             ("wx1", t.wx1, hp), ("ky", t.ky, wp),
                             ("wy0", t.wy0, wp), ("wy1", t.wy1, wp)):
        want = torch.int32 if name.startswith("k") else torch.float32
        if tab.device != imgs.device or tab.dtype != want \
                or tab.shape != (n, lines) or not tab.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {want} [{n}, {lines}]"
                             f" tensor on {imgs.device}, got {tab.dtype} "
                             f"{tuple(tab.shape)} on {tab.device}")


def _launch(imgs: torch.Tensor, t: ShearTables,
            tile: Tuple[int, int] | None = None) -> torch.Tensor:
    """Run ``csrc/rotate3shear.cu`` (one launch) on the current stream, in
    tiles of ``tile`` = (rows, cols) outputs (default: ``plan_tile`` for
    ``BLOCKS_PER_SM`` blocks an SM).  Raises ValueError for a frame whose x
    tables alone exceed a block's shared memory."""
    _check_launch(imgs, t)
    n, h, w, c = imgs.shape
    px, py, hp, wp, _, _ = frame_geometry(h, w)
    if tile is not None and not (1 <= tile[0] <= h and 1 <= tile[1] <= w):
        raise ValueError(f"tile {tile}: need 1 <= rows <= {h} and "
                         f"1 <= cols <= {w}")
    out = torch.empty_like(imgs)
    if out.numel() == 0:
        return out
    lib = _kernel_lib()
    if tile is None:
        # a frame too tall for the x tables of three blocks an SM (about
        # 6,000 rows on an H100) runs one block an SM (about 19,000)
        limit = smem_limit(imgs.device)
        if smem_bytes(1, staged_columns(1, 1, wp), c, hp) > limit:
            limit = smem_limit(imgs.device, 1)
        plan = plan_tile(h, w, c, limit)
    else:
        plan = Tile(*tile, staged_columns(*tile, wp))
        limit = smem_limit(imgs.device, 1)
        need = smem_bytes(plan.rows, plan.staged, c, hp)
        if need > limit:
            raise ValueError(f"tile {tile} of a [{h}, {w}, {c}] image needs "
                             f"{need} bytes of shared memory, more than "
                             f"{limit}")
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream(imgs.device).cuda_stream
        err = lib.rotate3shear(
            imgs.data_ptr(), int(imgs.dtype == torch.bfloat16),
            out.data_ptr(), *(tab.data_ptr() for tab in t), n, h, w, c, px,
            py, hp, wp, *plan, stream)
    _check(lib, err, "kernel launch")
    rotate_3shear.launches += 1
    return out


def rotate_3shear(imgs: torch.Tensor, thetas: torch.Tensor) -> torch.Tensor:
    """Rotate imgs [N, H, W, C] (float32 or bfloat16) about their centres by
    ``thetas`` [N] radians.  CPU tensors go through
    ``rotate_3shear_reference``; CUDA tensors through the kernel, counted in
    ``rotate_3shear.launches`` (one per call)."""
    _check_images(imgs, thetas)
    device = imgs.device
    if device.type == "cpu":
        return rotate_3shear_reference(imgs, thetas)
    if device.type != "cuda":
        raise ValueError(f"rotate_3shear: no kernel for device {device}")
    tables = shear_tables(thetas.to(device), imgs.shape[1], imgs.shape[2],
                          imgs.dtype)
    return _launch(imgs.contiguous(), tables)


rotate_3shear.launches = 0

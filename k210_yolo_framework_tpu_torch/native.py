"""ctypes bindings for the C++ host components: the JPEG/PNG batch loader
and the host-side region layer.

Counterpart of ``k210_yolo_framework_tpu/native.py`` (``available``,
``build``, ``decode_image``, ``NativeLoader``, ``region_layer_run``).  The
port compiles the same sources, the repository's ``csrc/loader.cpp``
(linked with ``-ljpeg -lpng -lpthread``) and ``csrc/region_layer.cpp``, with
its own ``g++`` call and ``csrc/Makefile``'s flags, into
``k210_yolo_framework_tpu_torch/_build/`` (listed in ``.gitignore``); it
runs no ``make`` and imports nothing of the JAX package.  A library's file
name carries a hash of its source and flags, so an edited source is
rebuilt.  Each build writes a temporary file and renames it into place, so
processes that build at once never load a half-written library.

A failed build is tried once more, then remembered for the process:
``available()`` returns False and ``NativeLoader`` / ``decode_image`` /
``region_layer_run`` raise a ``RuntimeError`` that carries the compiler's
first error line.  ``build()`` tries again.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["available", "build", "build_error", "NativeLoader",
           "decode_image", "region_layer_run"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# csrc/Makefile's flags (its portable default: no -march=native)
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
# library name -> (source in csrc/, link flags)
_SOURCES = {"yolo_loader": ("loader.cpp", ("-ljpeg", "-lpng", "-lpthread")),
            "yolo_region": ("region_layer.cpp", ())}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_errors: Dict[str, str] = {}      # name -> first error line of a failed build

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)


def _library_path(name: str) -> Path:
    src, libs = _SOURCES[name]
    h = hashlib.sha256((_CSRC / src).read_bytes())
    h.update(" ".join(CXX_FLAGS + libs).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _first_error(stderr: str) -> str:
    lines = [ln.strip() for ln in stderr.splitlines() if ln.strip()]
    return next((ln for ln in lines if "error" in ln), lines[0] if lines
                else "no compiler output")


def _compile(name: str) -> Path:
    """Compile ``name`` unless its library exists; raises RuntimeError with
    the compiler's first error line."""
    lib = _library_path(name)
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH")
    src, libs = _SOURCES[name]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(_CSRC / src),
                               *libs], capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(_first_error(proc.stderr))
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def _load(name: str) -> None:
    """Build (twice at most) and load ``name`` into ``_libs``, or record the
    failure in ``_errors``.  Holds ``_lock``."""
    err = ""
    for _ in range(2):
        try:
            _libs[name] = _bind(name, ctypes.CDLL(str(_compile(name))))
            _errors.pop(name, None)
            return
        except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
            err = str(e)
    _errors[name] = err


def _lib(name: str) -> ctypes.CDLL:
    """The loaded library, built at first use; raises RuntimeError with the
    build's first error line when it cannot be built."""
    with _lock:
        if name not in _libs and name not in _errors:
            _load(name)
        if name in _errors:
            raise RuntimeError(f"native {name} library unavailable: "
                               f"{_errors[name]}")
        return _libs[name]


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    if name == "yolo_loader":
        lib.yl_decode_image.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                        ctypes.c_int, _u8p, _i32p]
        lib.yl_decode_image.restype = ctypes.c_int
        lib.yl_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64]
        lib.yl_loader_create.restype = ctypes.c_void_p
        lib.yl_loader_next.argtypes = [ctypes.c_void_p, _u8p, _i32p, _i32p]
        lib.yl_loader_next.restype = ctypes.c_int
        lib.yl_loader_destroy.argtypes = [ctypes.c_void_p]
        lib.yl_loader_destroy.restype = None
    else:
        lib.yl_region_layer_run.argtypes = [
            ctypes.POINTER(_f32p), _i32p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, _f32p, _f32p, _i32p, _u8p]
        lib.yl_region_layer_run.restype = ctypes.c_int
    return lib


def build() -> bool:
    """(Re)try building and loading both libraries, forgetting an earlier
    failure.  Returns success."""
    with _lock:
        for name in _SOURCES:
            if name not in _libs:
                _errors.pop(name, None)
                _load(name)
        return not _errors


def available() -> bool:
    """Whether both libraries build and load (built at first call)."""
    try:
        for name in _SOURCES:
            _lib(name)
    except RuntimeError:
        return False
    return True


def build_error() -> str:
    """The first error line of a failed build, or '' (after ``available``)."""
    with _lock:
        return "; ".join(f"{k}: {v}" for k, v in _errors.items())


# ------------------------------------------------------------- loader ----

def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def decode_image(path: str, canvas_hw: Tuple[int, int]
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Decode ``path`` into a zeroed [ch, cw, 3] uint8 canvas, shrunk to fit
    if larger.  Returns (canvas, (h, w) int32); IOError if it cannot be
    decoded."""
    lib = _lib("yolo_loader")
    ch, cw = canvas_hw
    canvas = np.empty((ch, cw, 3), np.uint8)
    hw = np.empty((2,), np.int32)
    if lib.yl_decode_image(path.encode(), ch, cw, _ptr(canvas, _u8p),
                           _ptr(hw, _i32p)) != 0:
        raise IOError(f"native decode failed: {path}")
    return canvas, hw


class NativeLoader:
    """Epoch-shuffled batches decoded by C++ worker threads.

    ``next()`` returns (canvases [B, ch, cw, 3] uint8, hws [B, 2] int32,
    indices [B] int32): each slot's row of ``paths``, so the caller attaches
    the gt boxes.  The shuffle is the library's own (mt19937_64 from
    ``seed``), the JAX package's native loader's."""

    def __init__(self, paths: Sequence[str], canvas_hw: Tuple[int, int],
                 batch_size: int, seed: int, num_workers: int = 8,
                 prefetch: int = 4):
        lib = _lib("yolo_loader")
        self.canvas_hw = tuple(canvas_hw)
        self.batch_size = batch_size
        self._paths = [str(p) for p in paths]
        self._encoded = [p.encode() for p in self._paths]
        arr = (ctypes.c_char_p * len(self._encoded))(*self._encoded)
        handle = lib.yl_loader_create(arr, len(self._paths), canvas_hw[0],
                                      canvas_hw[1], batch_size, num_workers,
                                      prefetch, seed)
        if not handle:
            raise RuntimeError("native loader creation failed (no paths or "
                               "batch size < 1)")
        # bound now: at interpreter shutdown a finalizing generator may
        # find the module's globals torn down
        self._next = lib.yl_loader_next
        self._destroy = lib.yl_loader_destroy
        self._handle = handle

    def next(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self._handle is None:
            raise RuntimeError("native loader is closed")
        ch, cw = self.canvas_hw
        canvases = np.empty((self.batch_size, ch, cw, 3), np.uint8)
        hws = np.empty((self.batch_size, 2), np.int32)
        idxs = np.empty((self.batch_size,), np.int32)
        if self._next(self._handle, _ptr(canvases, _u8p), _ptr(hws, _i32p),
                      _ptr(idxs, _i32p)) != 0:
            raise RuntimeError("native loader stopped")
        if (idxs < 0).any():   # a failed decode comes back as -(index + 1)
            bad = int(-idxs[idxs < 0][0] - 1)
            raise IOError(f"native decode failed for sample index {bad} "
                          f"({self._paths[bad]})")
        return canvases, hws, idxs

    def close(self) -> None:
        if getattr(self, "_handle", None) is not None:
            self._destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


# ------------------------------------------------------- region layer ----

def region_layer_run(preds: List[np.ndarray], anchors: np.ndarray,
                     in_hw: Tuple[int, int], img_hw: Tuple[int, int],
                     obj_thresh: float = 0.7, iou_thresh: float = 0.3,
                     max_out: int = 30, class_softmax: bool = False):
    """Host-side decode + per-class NMS of ONE image.

    preds: per layer [h, w, a, 5 + C] float32 raw logits; anchors
    [layers, a, 2] normalised (w, h).  Returns (boxes [C * max_out, 4] yxyx
    pixels, scores, classes, valid)."""
    lib = _lib("yolo_region")
    n_layers = len(preds)
    a = preds[0].shape[2]
    classes = preds[0].shape[3] - 5
    preds32 = [np.ascontiguousarray(p, np.float32) for p in preds]
    ptrs = (_f32p * n_layers)(*[_ptr(p, _f32p) for p in preds32])
    grid_hw = np.array([p.shape[:2] for p in preds32], np.int32).ravel()
    anchors32 = np.ascontiguousarray(anchors, np.float32)
    n_out = classes * max_out
    boxes = np.empty((n_out, 4), np.float32)
    scores = np.empty((n_out,), np.float32)
    out_classes = np.empty((n_out,), np.int32)
    valid = np.empty((n_out,), np.uint8)
    lib.yl_region_layer_run(
        ptrs, _ptr(grid_hw, _i32p), n_layers, a, classes,
        _ptr(anchors32, _f32p), in_hw[0], in_hw[1], img_hw[0], img_hw[1],
        obj_thresh, iou_thresh, max_out, int(class_softmax),
        _ptr(boxes, _f32p), _ptr(scores, _f32p), _ptr(out_classes, _i32p),
        _ptr(valid, _u8p))
    return boxes, scores, out_classes, valid.astype(bool)

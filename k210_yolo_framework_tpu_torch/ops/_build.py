"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled by ``nvcc`` for ``sm_90a`` into a shared library and loaded with
``ctypes``.  The library's file name carries a hash of the source, of every
shared header ``csrc/*.cuh`` and of the flags, so an edited source or header
is rebuilt and an unchanged one is loaded from ``_build/`` (listed in
``.gitignore``).  Only the CUDA sources inside the package are compiled
here; the repository's C++ host sources (``csrc/loader.cpp``,
``csrc/region_layer.cpp``) are built by ``native.py`` with ``g++``.
``largest_fitting`` searches a kernel's shared-memory footprint, as its
library reports it, against a device's limit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build", "largest_fitting", "load", "source_digest"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# No fast math and no mul+add contraction: the kernels' arithmetic must
# match their plain PyTorch versions operation by operation.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc"
        if Path("/usr/local/cuda/bin/nvcc").exists() else None)
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
            "CUDA kernels are compiled at first use")
    return found


def source_digest(name: str) -> str:
    """Hash of ``csrc/<name>.cu``, of every ``csrc/*.cuh`` (all of them: a
    source may include any) and of the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists.
    Returns the library path and the compiler's output (``-Xptxas -v``
    register and shared-memory report; empty when nothing was built)."""
    src = CSRC / f"{name}.cu"
    digest = source_digest(name)
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name, then rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, once per process."""
    lib, _ = build(name)
    return ctypes.CDLL(str(lib))


def largest_fitting(footprint, limit: int, hi: int = 1 << 16) -> int:
    """Largest x in [0, hi] with ``footprint(x) <= limit``, where the x that
    fit are a prefix of [0, hi]; 0 when none fits."""
    lo = 0
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if footprint(mid) <= limit:
            lo = mid
        else:
            hi = mid - 1
    return lo

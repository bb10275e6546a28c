#!/usr/bin/env python3
"""Where the rotation kernel (``csrc/rotate3shear.cu``) spends its time on
one NVIDIA GPU: the kernel built as it is and with one of its two walks cut
out, each timed on the card alone (``chip_smoke.device_ms``) at the train
path's shape (42 images of 224x320x3, bf16, its planned tile).

    python3 rotate_phases.py

Variants, made by text substitution on the source and built by nvcc into
``k210_yolo_framework_tpu_torch/_build/phases/``:

  full      the kernel as it is (checked against ``_rotate_plain``)
  no_stage  no staged column walked: passes 1 and 2 skipped
  no_pass3  no output walked: pass 3 and the stores skipped

A cut variant computes wrong outputs; only its time is read.  The
difference between two variants is what the cut part costs inside the
kernel, where counters (``ncu``) are not available.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from chip_smoke import device_ms, gpu_label

VARIANTS = {
    "full": (),
    "no_stage": (("  for (int j = tid; j < ncc; j += kThreads) {",
                  "  for (int j = tid; j < 0; j += kThreads) {"),),
    "no_pass3": (("  for (int j = tid; j < cols * g.c; j += kThreads) {",
                  "  for (int j = tid; j < 0; j += kThreads) {"),),
}


def build_variants():
    """One library per variant, nvcc started for all together."""
    from k210_yolo_framework_tpu_torch.ops import _build

    src = (_build.CSRC / "rotate3shear.cu").read_text()
    out = _build.BUILD_DIR / "phases"
    out.mkdir(parents=True, exist_ok=True)

    def build(name):
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise AssertionError(f"{name}: {old!r} not in the source")
            text = text.replace(old, new)
        cu, lib = out / f"rotate_{name}.cu", out / f"librotate_{name}.so"
        cu.write_text(text)
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                               str(_build.CSRC), "-o", str(lib), str(cu)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
        return lib

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        return dict(zip(VARIANTS, pool.map(build, VARIANTS)))


def main() -> int:
    import torch

    from k210_yolo_framework_tpu_torch.ops import rotate_pallas as TR

    if not torch.cuda.is_available():
        print("rotate_phases: no CUDA device", file=sys.stderr)
        return 1
    print(gpu_label())
    libs = build_variants()
    device = torch.device("cuda")
    rng = np.random.default_rng(4)
    n, h, w, c = 42, 224, 320, 3
    imgs = torch.from_numpy(rng.integers(0, 256, (n, h, w, c)).astype(
        np.float32)).to(device).to(torch.bfloat16)
    tables = TR.shear_tables(torch.from_numpy(np.deg2rad(
        rng.uniform(-10, 10, n)).astype(np.float32)).to(device), h, w,
        torch.bfloat16)
    px, py, hp, wp, _, _ = TR.frame_geometry(h, w)
    tile = TR.plan_tile(h, w, c, TR.smem_limit(device))
    out = torch.empty_like(imgs)
    times = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.rotate3shear.argtypes = (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
        lib.rotate3shear.restype = ctypes.c_int

        def kern():
            err = lib.rotate3shear(
                imgs.data_ptr(), 1, out.data_ptr(),
                *(t.data_ptr() for t in tables), n, h, w, c, px, py, hp, wp,
                *tile, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"{name}: launch failed ({err})")

        kern()
        torch.cuda.synchronize()
        if name == "full" and not torch.equal(out,
                                              TR._rotate_plain(imgs, tables)):
            raise AssertionError("the full kernel is not the plain result")
        times[name] = device_ms(kern, 20)
    print(json.dumps({"tile": list(tile), "device_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

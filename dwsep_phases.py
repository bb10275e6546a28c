#!/usr/bin/env python3
"""Where the fused block's bf16 kernel (``csrc/dwsep.cu``) spends its time on
one NVIDIA GPU: the kernel built as it is and with one phase cut out, each
timed at the shapes of the served net's stride-1 blocks (yolo_mobilev1,
alpha 0.75, B=128, bf16, seeded random inputs).

    python3 dwsep_phases.py

Variants, made by text substitution on the source and built by nvcc into
``k210_yolo_framework_tpu_torch/_build/phases/``:

  full     the kernel as it is (checked against ``fused_dwsep_reference``)
  no_mma   the tensor-core products skipped
  mma_x2   every product done twice
  no_pw_k  no chunk of pw_k loaded (the ring is waited on all the same)
  only_dw  the depthwise phase alone: no chunk loaded, no product, no store

A cut variant computes wrong outputs; only its time is read.  The
difference between two variants is what the cut part costs inside the
kernel, where counters (``ncu``) are not available.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from chip_smoke import dwsep_bound, gpu_label, time_ms

# (block, H, W, C, Cout) of the served net's stride-1 blocks at 224x320;
# blocks 8-11 have block_7's shape
SHAPES = ((1, 112, 160, 24, 48), (3, 56, 80, 96, 96), (5, 28, 40, 192, 192),
          (7, 14, 20, 384, 384), (13, 7, 10, 768, 768))
NO_PW_K = ("    if (next_q < total)\n", "    if (next_q < 0)\n")
VARIANTS = {
    "full": (),
    "no_mma": (("if (ni < live) mma_bf16(", "if (ni < live && n0 < 0) mma_bf16("),),
    "mma_x2": (("if (ni < live) mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);",
                "if (ni < live) {\n"
                "  mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);\n"
                "  mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);\n}"),),
    "no_pw_k": (NO_PW_K,),
    "only_dw": (NO_PW_K, ("for (int q = 0; q < total; ++q) {",
                          "for (int q = 0; q < 0; ++q) {")),
}


def build_variants():
    """One library per variant, nvcc started for all together."""
    from k210_yolo_framework_tpu_torch.ops import _build

    src = (_build.CSRC / "dwsep.cu").read_text()
    out = _build.BUILD_DIR / "phases"
    out.mkdir(parents=True, exist_ok=True)

    def build(name):
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        cu, lib = out / f"dwsep_{name}.cu", out / f"libdwsep_{name}.so"
        cu.write_text(text)
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                               str(_build.CSRC), "-o", str(lib), str(cu)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {cu.name}:\n{proc.stderr}")
        lib = ctypes.CDLL(str(lib))
        lib.dwsep_forward.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
        return lib

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        return dict(zip(VARIANTS, pool.map(build, VARIANTS)))


def main() -> int:
    import torch

    from k210_yolo_framework_tpu_torch.ops import dwsep_pallas as TF

    if not torch.cuda.is_available():
        print("dwsep_phases: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    libs = build_variants()
    tag = f"[{gpu_label()}]"
    for block, h, w, c, cout in SHAPES:
        rng = np.random.default_rng(block)
        x = torch.from_numpy(rng.uniform(0, 1, (128, h, w, c)).astype(
            np.float32)).to(dev).to(torch.bfloat16)
        p = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
            rng.normal(0, 0.3, (3, 3, c)), rng.uniform(0.5, 1.5, c),
            rng.normal(0, 0.2, c), rng.normal(0, 0.1, (c, cout)),
            rng.uniform(0.5, 1.5, cout), rng.normal(0, 0.2, cout))]
        pw_k = p[3].to(torch.bfloat16)
        out = torch.empty((128, h, w, cout), dtype=torch.bfloat16, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        times = {}
        for name, lib in libs.items():
            def run(lib=lib):
                err = lib.dwsep_forward(
                    x.data_ptr(), p[0].data_ptr(), p[1].data_ptr(),
                    p[2].data_ptr(), pw_k.data_ptr(), p[4].data_ptr(),
                    p[5].data_ptr(), out.data_ptr(), 128, h, w, c, cout, 1,
                    0.3, stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")
            run()
            if name == "full":
                want = TF.fused_dwsep_reference(x, *p).float()
                if not torch.allclose(out.float(), want, rtol=0.05,
                                      atol=0.05):
                    raise AssertionError(f"block_{block}: full disagrees")
            times[name] = time_ms(run, 20)
        b_ms, by = dwsep_bound(x, cout)
        print(f"dwsep phases b128 block_{block} {h}x{w}x{c}->{cout}: "
              + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
              + f" ms; bound {b_ms:.4f} ms ({by}) {tag}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

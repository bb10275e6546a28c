#!/usr/bin/env python3
"""Where the fused head's global path (``csrc/yolo_head.cu``) spends its time
on one NVIDIA GPU, at a scoring cell's own traffic: the served net's logits
of one pool batch of ``yolov3-608-eval-b32`` (B=32, N=22,743, obj 0.01,
NMS 0.45, max_out 100), its weights and inputs made from the seed by the
benchmark's harness (``yolo_bench``).

    python3 greedy_phases.py [--root DIR] [--cell NAME] [--seed N]

``--root`` names the checkout whose kernels are split (default: the one
beside this script); the harness is this script's.  Run the parent and the
change in one call.  Variants, made by text substitution on the sources and
built by nvcc into ``k210_yolo_framework_tpu_torch/_build/phases/``:

  where the head selects with the step loop (greedy_select.cuh):
    full        the kernel as it is
    first_pass  every row's step loop cut: the decode and the first pass
  where it selects in score order (ordered_select.cuh):
    full        the decode and the select kernel as they are
    decode      the decode kernel alone
    timed       the select kernel with clock64() around its rounds' radix
                select, gather and sort, and around their scans, summed
                over the blocks

The difference between two variants, or the timed variant's shares of the
select kernel's time, is what a phase costs, where counters (``ncu``) are
not available.  Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent

STEP_VARIANTS = {
    "full": (),
    "first_pass": (("greedy_select.cuh", "    for (; k < max_out; ++k) {",
                    "    for (; k < 0; ++k) {"),),
}
ORDERED_VARIANTS = {
    "full": (),
    "decode": (("yolo_head.cu", "  yolo_head_kernel_select<<<",
                "  if (0) yolo_head_kernel_select<<<"),),
    "timed": (
        ("ordered_select.cuh", "typedef unsigned long long Key;\n",
         "typedef unsigned long long Key;\n"
         "__device__ unsigned long long g_phase[2];\n"),
        ("ordered_select.cuh", "    const Key lo = remaining <= kCap",
         "    const long long t0 = clock64();\n"
         "    const Key lo = remaining <= kCap"),
        ("ordered_select.cuh",
         "    for (int base = 0; base < m; base += kThreads) {\n",
         "    const long long t1 = clock64();\n"
         "    if (threadIdx.x == 0) atomicAdd(&g_phase[0], "
         "(unsigned long long)(t1 - t0));\n"
         "    for (int base = 0; base < m; base += kThreads) {\n"),
        ("ordered_select.cuh", "    remaining -= m;\n",
         "    if (threadIdx.x == 0) atomicAdd(&g_phase[1], "
         "(unsigned long long)(clock64() - t1));\n"
         "    remaining -= m;\n"),
        ("yolo_head.cu", 'const char* yolo_head_error_string(int code) {',
         "int yolo_head_phase_cycles(unsigned long long* out, int reset) {\n"
         "  if (reset) {\n"
         "    const unsigned long long zero[2] = {0, 0};\n"
         "    return (int)cudaMemcpyToSymbol(ordered::g_phase, zero,\n"
         "                                   sizeof(zero));\n"
         "  }\n"
         "  return (int)cudaMemcpyFromSymbol(out, ordered::g_phase,\n"
         "                                   2 * sizeof(*out));\n"
         "}\n\n"
         'const char* yolo_head_error_string(int code) {'),
    ),
}


def build_variants(csrc: Path, out: Path, variants: dict) -> dict:
    """One library per variant: the sources copied to a directory of its
    own, substituted there, nvcc started for all together."""
    from k210_yolo_framework_tpu_torch.ops import _build

    def build(name):
        where = out / name
        if where.exists():
            shutil.rmtree(where)
        where.mkdir(parents=True)
        for src in list(csrc.glob("*.cuh")) + [csrc / "yolo_head.cu"]:
            shutil.copy(src, where / src.name)
        for file, old, new in variants[name]:
            text = (where / file).read_text()
            if old not in text:
                raise RuntimeError(f"{name}: {file} no longer has {old!r}")
            (where / file).write_text(text.replace(old, new))
        lib = where / f"libyolo_head_{name}.so"
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                               str(lib), str(where / "yolo_head.cu")],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
        return ctypes.CDLL(str(lib))

    with ThreadPoolExecutor(len(variants)) as pool:
        return dict(zip(variants, pool.map(build, variants)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose kernels are split")
    ap.add_argument("--cell", default="yolov3-608-eval-b32")
    ap.add_argument("--seed", type=int, default=2300000001)
    ap.add_argument("--label", default="", help="name printed with the times")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    sys.path.insert(1, str(HERE))
    spec_ = importlib.util.spec_from_file_location("chip_smoke_timers",
                                                   HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(cs)

    import torch

    if not torch.cuda.is_available():
        print("greedy_phases: no CUDA device", file=sys.stderr)
        return 1
    import k210_yolo_framework_tpu_torch as pkg
    from k210_yolo_framework_tpu_torch.ops import _build
    from k210_yolo_framework_tpu_torch.ops import yolo_head_pallas as TH
    from yolo_bench import counts, serving
    from yolo_bench.run import Cell

    if Path(pkg.__file__).resolve().parent.parent != root:
        raise AssertionError(f"imported {pkg.__file__}, not from {root}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(cs.gpu_label())

    cell = Cell(args.cell)
    tr = cell.traffic
    thresh, iou, max_out = tr["obj_thresh"], tr["iou_thresh"], tr["max_out"]
    sv = serving.Serving(cell, args.seed, dev)
    pred = sv.predictor
    spec = pred.spec
    with torch.inference_mode():
        preds = pred._forward_batch(sv.inputs["canvases"][0],
                                    sv.inputs["img_hws"][0])
    p = TH._flatten_preds(preds, spec.class_num)
    geom = TH._geometry_on(spec, dev)
    lbox = TH.letterbox_inverse_params(sv.inputs["img_hws"][0],
                                       spec.in_hw).contiguous()
    bsz, n, _ = p.shape
    classes = spec.class_num
    kw = dict(classes=classes, max_out=max_out, iou_thresh=iou,
              score_thresh=thresh, class_softmax=False)
    want = TH._launch(p, geom, lbox, **kw)
    out_s = torch.empty_like(want[0])
    out_b = torch.empty_like(want[1])
    stream = torch.cuda.current_stream().cuda_stream
    ordered = (_build.CSRC / "ordered_select.cuh").exists()
    variants = ORDERED_VARIANTS if ordered else STEP_VARIANTS
    libs = build_variants(_build.CSRC, _build.BUILD_DIR / "phases", variants)
    tally = torch.zeros(1, dtype=torch.int64, device=dev)
    if ordered:
        scratch = torch.empty(
            TH._kernel_lib().yolo_head_ordered_scratch_bytes(bsz, n, classes),
            dtype=torch.uint8, device=dev)
    else:
        rows = TH.global_rows(bsz, classes, TH._sms(dev),
                              TH._kernel_lib().yolo_head_max_rows())
        scratch = torch.empty(bsz * -(-classes // rows) * TH._kernel_lib()
                              .yolo_head_scratch_bytes(n, rows) // 4,
                              dtype=torch.float32, device=dev)

    def launcher(name, lib):
        if ordered:
            lib.yolo_head_ordered.argtypes = [ctypes.c_void_p] * 7 + [
                ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [
                ctypes.c_int, ctypes.c_void_p]
            args = (p.data_ptr(), geom.data_ptr(), lbox.data_ptr(),
                    out_s.data_ptr(), out_b.data_ptr(), scratch.data_ptr(),
                    tally.data_ptr(), bsz, n, classes, max_out, iou, thresh,
                    0, stream)
            fn = lib.yolo_head_ordered
            fn.restype = ctypes.c_int
        else:
            lib.yolo_head_decode_nms.argtypes = [ctypes.c_void_p] * 6 + [
                ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [
                ctypes.c_int, ctypes.c_void_p]
            args = (p.data_ptr(), geom.data_ptr(), lbox.data_ptr(),
                    out_s.data_ptr(), out_b.data_ptr(), scratch.data_ptr(),
                    bsz, n, classes, rows, max_out, iou, thresh, 0, stream)
            fn = lib.yolo_head_decode_nms
            fn.restype = ctypes.c_int

        def run():
            err = fn(*args)
            if err:
                raise RuntimeError(f"{name}: launch failed ({err})")
        return run

    runs = {name: launcher(name, lib) for name, lib in libs.items()}
    runs["full"]()
    torch.cuda.synchronize()
    if not (torch.equal(out_s, want[0]) and torch.equal(out_b, want[1])):
        raise AssertionError("the full variant disagrees with the package")
    times = {name: {"events_ms": cs.time_ms(run, 20),
                    "device_ms": cs.device_ms(run, 20)}
             for name, run in runs.items()}
    # the plain version on the card, and the bound the benchmark divides by
    # (``yolo_bench.counts``: the step loop's live tests)
    live = []
    plain = lambda: TH._decode_and_select(  # noqa: E731
        p, geom, lbox, classes=classes, max_out=max_out, iou_thresh=iou,
        class_softmax=False, stop_below=thresh)
    TH._decode_and_select(p, geom, lbox, classes=classes, max_out=max_out,
                          iou_thresh=iou, class_softmax=False,
                          stop_below=thresh, live=live)
    work = counts.head_work(bsz, n, classes, max_out, sum(live))
    times["plain"] = {"events_ms": cs.time_ms(plain, 3, warmup=1)}
    line = {"label": args.label, "cell": args.cell, "seed": args.seed,
            "B": bsz, "N": n, "path": "ordered" if ordered else "step loop",
            "ms": times, "bound_ms": 1e3 * counts.bound_s(
                work["bytes"], work["ops"], counts.H100_FP32_FLOPS),
            "live_tests": sum(live)}
    full = times["full"]["device_ms"]
    if ordered:
        timed = libs["timed"]
        cycles = (ctypes.c_ulonglong * 2)()
        timed.yolo_head_phase_cycles.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_int]
        timed.yolo_head_phase_cycles.restype = ctypes.c_int
        torch.cuda.synchronize()
        timed.yolo_head_phase_cycles(None, 1)
        tally.zero_()
        runs["timed"]()
        torch.cuda.synchronize()
        if timed.yolo_head_phase_cycles(cycles, 0):
            raise RuntimeError("reading the phase cycles failed")
        rounds, scan = cycles[0], cycles[1]
        decode = times["decode"]["device_ms"]
        select = full - decode
        line["split_ms"] = {
            "decode": decode,
            "select_rounds": select * rounds / (rounds + scan),
            "scan": select * scan / (rounds + scan)}
        line["scan_depth_a_row"] = int(tally.item()) / (bsz * classes)
    else:
        first = times["first_pass"]["device_ms"]
        line["split_ms"] = {"decode_and_first_pass": first,
                            "steps": full - first}
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())

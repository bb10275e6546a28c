#!/usr/bin/env python3
"""Drive the PyTorch port's main serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

  1. device: requires ``torch.cuda.is_available()``; prints the card's name
     and power limit as nvidia-smi reports them;
  2. build: compiles the port's CUDA kernel from the sources in this
     checkout (``k210_yolo_framework_tpu_torch/csrc/yolo_head.cu``);
  3. the kernel against its plain PyTorch version on the card, at the
     serving shapes (VOC, B=128, N=1050, C=20), both score flavours, on
     sparse, dense, empty, NaN, tied and 3-scale (N=4410) inputs;
  4. the slice: a seeded yolo_mobilev1 (alpha 0.75) served in bf16 through
     ``Predictor.predict_batch`` (128 canvases of 240x320, mixed image sizes)
     and ``predict_image``, in three scenes: obj_thresh 0.7 (no detections
     from random weights), obj_thresh 0.25 (most rows keep 30 boxes) and
     dense-scene head biases.  The head kernel must have been launched once
     per call, and the detections of the scenes that have any must match
     the same Predictor's forward through the plain head;
  5. times, from CUDA events: serving images/s at batch 128, batch-1
     latency, and the head kernel against its plain version;
  6. where the device time goes: torch.profiler kernel events (each kernel
     once) of one serving call at batch 128 and at batch 1.

The next-to-last line is one JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.  Nothing of JAX is imported: the
script imports only the port, whose one module from the JAX package is the
numpy-only ``config``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

BATCH = 128
CANVAS_HW = (240, 320)
# tolerances of tests/test_yolo_head_pallas.py (the JAX package's own)
SCORE_TOL = dict(rtol=2e-5, atol=1e-6)
BOX_TOL = dict(rtol=1e-3, atol=0.05)
# a `valid` flip is accepted only where the score is this close to the
# threshold (the last winner of a row; nothing after it is kept)
BORDER = 1e-5
FLAVOURS = ((False, 0.7), (True, 0.03))   # (class_softmax, score_thresh)
IOU = 0.3
# the mid scene's threshold: the seeded random net's scores,
# sigmoid(cls) * sigmoid(conf) of logits near 0, lie around it
MID_THRESH = 0.25


def gpu_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, from CUDA events
    recorded on the current stream after a warm-up and a synchronize."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


KERNEL_CATEGORIES = (
    ("head kernel", ("yolo_head",)),
    ("conv/matmul", ("conv2d", "convolve", "depthwise", "gemm",
                     "cudnn", "xmma", "cutlass", "fprop")),
)


def kernel_profile(fn, iters: int):
    """Device activity of one call of ``fn``, averaged over ``iters`` calls
    under torch.profiler.  Only device events count (kernels, memcpy,
    memset), each once: the host-side op events that launched them are
    left out.  Returns (kernels per call, device ms per call, {category: ms
    per call}, the 8 costliest kernels as (name, ms per call, launches per
    call))."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per_name = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        count, us = per_name.get(ev.name, (0, 0.0))
        per_name[ev.name] = (count + 1, us + ev.time_range.elapsed_us())
    by_cat = {"head kernel": 0.0, "conv/matmul": 0.0,
              "elementwise/other": 0.0, "memcpy/memset": 0.0}
    n_kernels = 0
    for name, (count, us) in per_name.items():
        low = name.lower()
        if low.startswith(("memcpy", "memset")):
            cat = "memcpy/memset"
        else:
            n_kernels += count
            cat = next((c for c, keys in KERNEL_CATEGORIES
                        if any(k in low for k in keys)), "elementwise/other")
        by_cat[cat] += us / 1e3 / iters
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:8]
    return (n_kernels / iters, sum(by_cat.values()), by_cat,
            [(name, us / 1e3 / iters, count / iters)
             for name, (count, us) in top])


def to_np(res):
    return type(res)(*(t.cpu().numpy() for t in res))


def compare_heads(got, want, thresh: float):
    """Hold the kernel's NmsResult to the plain version's.  Returns (max
    absolute difference over the slots both keep, number of accepted
    borderline `valid` flips)."""
    g, w = to_np(got), to_np(want)
    flip = g.valid != w.valid
    near = np.abs(np.where(g.valid, g.scores, w.scores)[flip] - thresh)
    if np.any(near > BORDER):
        raise AssertionError(
            f"{int(flip.sum())} valid flips, {int((near > BORDER).sum())} "
            f"away from the threshold")
    both = g.valid & w.valid
    np.testing.assert_array_equal(g.classes, w.classes)
    np.testing.assert_allclose(g.scores[both], w.scores[both], **SCORE_TOL)
    np.testing.assert_allclose(g.boxes[both], w.boxes[both], **BOX_TOL)
    err = 0.0
    for a, b in ((g.scores[both], w.scores[both]),
                 (g.boxes[both], w.boxes[both])):
        d = np.where(a == b, 0.0, np.abs(a.astype(np.float64) - b))
        err = max(err, float(d.max(initial=0.0)))
    return err, int(flip.sum())


def head_cases(spec, spec3, device):
    """(name, spec, per-layer logits, img_hws) on ``device``."""
    import torch

    rng = np.random.default_rng(0)

    def logits(s, std=2.0):
        return [rng.normal(0, std, (BATCH, h, w, s.nanchors, 5 + s.class_num))
                .astype(np.float32) for h, w in s.out_hws]

    hws = rng.integers(100, 512, (BATCH, 2)).astype(np.int32)
    sparse = logits(spec)
    dense = [p.copy() for p in sparse]
    for p in dense:
        p[..., 4:] += 3.0
    empty = [np.full_like(p, -10.0) for p in sparse]
    nan = [p.copy() for p in sparse]
    nan[0][0] = np.nan                     # image 0: every row NaN
    nan[1][1, 3, 4, 0, 5 + 3] = np.nan     # image 1: class 3 row NaN
    nan[0][2, 1, 2, 1, 4] = np.nan         # image 2: a NaN conf, all rows
    ties = [p.copy() for p in sparse]
    for p in ties:
        p[..., 4:] = 2.0                   # every score equal
    cases = [("sparse", spec, sparse), ("dense", spec, dense),
             ("empty", spec, empty), ("nan", spec, nan), ("ties", spec, ties),
             ("three_scale", spec3, logits(spec3))]
    dev_hws = torch.from_numpy(hws).to(device)
    return [(name, s, [torch.from_numpy(p).to(device) for p in ps], dev_hws)
            for name, s, ps in cases]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1
    return run(torch.device("cuda"))


def run(device) -> int:
    import torch

    from k210_yolo_framework_tpu_torch import YoloSpec, voc_spec
    from k210_yolo_framework_tpu_torch.inference import (
        Predictor,
        stack_detections,
    )
    from k210_yolo_framework_tpu_torch.models import build_network
    from k210_yolo_framework_tpu_torch.ops import _build
    from k210_yolo_framework_tpu_torch.ops import letterbox as LB
    from k210_yolo_framework_tpu_torch.ops import yolo_head_pallas as TH
    from k210_yolo_framework_tpu_torch.utils.detmatch import (
        assert_detections_close,
    )

    # fp32 comparisons run in full fp32 (TF32 off for cuDNN and matmul)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---- 1. device ------------------------------------------------------
    gpu = gpu_label()
    print(gpu)
    tag = f"[{gpu}]"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, log = _build.build("yolo_head")
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # ---- 3. kernel against its plain version ---------------------------
    spec = voc_spec()
    rng = np.random.default_rng(1)
    anchors3 = np.sort(rng.uniform(0.05, 0.9, (3, 3, 2)))[:, ::-1]
    spec3 = YoloSpec.create((224, 320), ((7, 10), (14, 20), (28, 40)), 20,
                            anchors3)
    max_err, flips = 0.0, 0
    for name, s, preds, hws in head_cases(spec, spec3, device):
        for softmax, thresh in FLAVOURS:
            got = TH.fused_decode_nms(preds, s, hws, thresh, IOU, 30, softmax)
            torch.cuda.synchronize()
            want = TH.fused_decode_nms_reference(preds, s, hws, thresh, IOU,
                                                 30, softmax)
            err, flip = compare_heads(got, want, thresh)
            max_err, flips = max(max_err, err), flips + flip
            n_valid = int(got.valid.sum())
            full = int(got.valid.reshape(BATCH, s.class_num, 30).all(-1).sum())
            n = sum(p[0].numel() for p in preds) // (5 + s.class_num)
            print(f"kernel vs plain: {name:<11} softmax={softmax!s:<5} "
                  f"N={n} kept={n_valid} "
                  f"full_rows={full}/{BATCH * s.class_num} "
                  f"max_abs_err={err:.3g} borderline_flips={flip}")
            if name == "empty" and n_valid:
                raise AssertionError("detections from an empty scene")
            if name == "dense" and not softmax and full != BATCH * s.class_num:
                raise AssertionError("dense scene: not every row ran 30 steps")

    # ---- 4. the slice ---------------------------------------------------
    net = build_network("yolo_mobilev1", spec.in_hw, spec.nanchors,
                        spec.class_num, alpha=0.75,
                        generator=torch.Generator().manual_seed(0))
    serve = dict(iou_thresh=IOU, compute_dtype=torch.bfloat16, device=device)
    pred = Predictor(net, None, spec, obj_thresh=0.7, **serve)
    mid_pred = Predictor(net, None, spec, obj_thresh=MID_THRESH, **serve)
    dense_state = {k: v.clone() for k, v in net.state_dict().items()}
    e = 5 + spec.class_num
    for layer in ("y1_out", "y2_out"):
        bias = dense_state[f"head.{layer}.dark_conv_out.bias"]
        for a in range(spec.nanchors):
            bias[a * e + 4:(a + 1) * e] += 3.0   # conf and every class
    dense_pred = Predictor(net, dense_state, spec, obj_thresh=0.7, **serve)
    scenes = (("sparse", pred), ("mid", mid_pred), ("dense", dense_pred))

    rng = np.random.default_rng(2)
    hws = np.tile(np.asarray(CANVAS_HW, np.int32), (BATCH, 1))
    hws[BATCH // 2:] = np.stack([rng.integers(60, CANVAS_HW[0] + 1, BATCH // 2),
                                 rng.integers(60, CANVAS_HW[1] + 1, BATCH // 2)],
                                -1)
    canvases = np.zeros((BATCH, *CANVAS_HW, 3), np.uint8)
    for b, (h, w) in enumerate(hws):
        canvases[b, :h, :w] = rng.integers(0, 256, (h, w, 3))
    image = rng.integers(0, 256, (375, 500, 3)).astype(np.uint8)

    TH.fused_decode_nms.launches = 0
    served = {name: (p.predict_batch(canvases, hws), p.predict_image(image))
              for name, p in scenes}
    launches = TH.fused_decode_nms.launches
    print(f"slice: head kernel launches {launches} in "
          f"{2 * len(scenes)} serving calls")
    if launches != 2 * len(scenes):
        raise AssertionError(f"head kernel launched {launches} times, "
                             "expected one per serving call")
    for name, p in scenes:
        dets, one = served[name]
        print(f"slice {name:<6} (obj_thresh {p.obj_thresh}): predict_batch "
              f"x{BATCH} -> {sum(len(d.scores) for d in dets)} of "
              f"{BATCH * spec.class_num * 30} slots; predict_image -> "
              f"{len(one.scores)}")
        for d in dets + [one]:
            if not (np.isfinite(d.scores).all()
                    and (d.scores >= p.obj_thresh).all()
                    and ((d.classes >= 0) & (d.classes < spec.class_num)).all()
                    and d.boxes.shape == (len(d.scores), 4)):
                raise AssertionError(f"{name}: malformed detections")
        if name != "sparse" and (sum(len(d.scores) for d in dets) == 0
                                 or len(one.scores) == 0):
            raise AssertionError(f"{name} scene produced no detections")

    # the same Predictors with the plain head, on the same forward
    c_dev = torch.from_numpy(canvases).to(device)
    h_dev = torch.from_numpy(hws).to(device)
    img_t = torch.from_numpy(image).to(device)
    hw1 = torch.tensor([image.shape[:2]], dtype=torch.int32, device=device)
    slice_err, slice_preds = 0.0, None
    for name, p in scenes:
        dets, one = served[name]
        with torch.inference_mode():
            lb = LB.letterbox_image(img_t[None], hw1, spec.in_hw,
                                    torch.float32).to(torch.uint8)
            inputs = ((p._forward_batch(c_dev, h_dev), h_dev, dets),
                      (p._forward(lb), hw1, [one]))
        for what, (preds, hws_, dets_) in zip(("batch", "image"), inputs):
            got = p._head(preds, hws_)
            want = TH.fused_decode_nms_reference(preds, spec, hws_,
                                                 p.obj_thresh, IOU, 30)
            err, flip = compare_heads(got, want, p.obj_thresh)
            slice_err = max(slice_err, err)
            n_a, n_b = assert_detections_close(stack_detections(dets_),
                                               to_np(want))
            print(f"slice vs plain head: {name:<6} {what}: served {n_a}, "
                  f"plain {n_b}; same forward max_abs_err={err:.3g} "
                  f"borderline_flips={flip}")
        if slice_preds is None:
            slice_preds = inputs[0][0]

    # a small input, fp32 on the card against fp32 on the CPU
    small = dict(obj_thresh=0.2, iou_thresh=0.45,
                 compute_dtype=torch.float32)
    ref_cpu = Predictor(net, None, spec, device="cpu", **small)
    on_gpu = Predictor(net, None, spec, device=device, **small)
    part = slice(BATCH // 2 - 4, BATCH // 2 + 4)   # full and cut images
    a = on_gpu.predict_batch(canvases[part], hws[part])
    b = ref_cpu.predict_batch(canvases[part], hws[part])
    n_a, n_b = assert_detections_close(stack_detections(a),
                                       stack_detections(b))
    print(f"slice fp32 card vs CPU (8 images, obj_thresh 0.2): {n_a} vs "
          f"{n_b} detections match")

    # ---- 5. times -------------------------------------------------------
    serve_ms = time_ms(lambda: pred._run_batch(c_dev, h_dev), 20)
    dense_ms = time_ms(lambda: dense_pred._run_batch(c_dev, h_dev), 20)
    b1_ms = time_ms(lambda: pred._run_batch(c_dev[:1], h_dev[:1]), 50)
    print(f"serve b{BATCH} sparse: {serve_ms:.3f} ms/batch = "
          f"{BATCH * 1e3 / serve_ms:.1f} imgs/s {tag}")
    print(f"serve b{BATCH} dense : {dense_ms:.3f} ms/batch = "
          f"{BATCH * 1e3 / dense_ms:.1f} imgs/s {tag}")
    print(f"serve b1 latency   : {b1_ms:.3f} ms {tag}")
    with torch.inference_mode():
        lb_ms = time_ms(lambda: LB.letterbox_image(
            c_dev, h_dev, spec.in_hw, torch.bfloat16), 20)
        imgs = LB.letterbox_image(c_dev, h_dev, spec.in_hw,
                                  torch.bfloat16).to(torch.uint8)
        fwd_ms = time_ms(lambda: pred._forward(imgs), 20)
    print(f"stages b{BATCH}: letterbox {lb_ms:.3f} ms, net {fwd_ms:.3f} ms "
          f"{tag}")
    print(f"peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB {tag}")

    cases = {name: (s, preds, hws_)
             for name, s, preds, hws_ in head_cases(spec, spec3, device)}
    cases["slice"] = (spec, slice_preds, h_dev)
    head_times = {}
    for name in ("slice", "sparse", "dense"):
        s, preds, hws_ = cases[name]
        # the kernel alone against the plain version of the same function,
        # on the same prepared inputs ...
        p = TH._flatten_preds(preds, s.class_num)
        geom = TH._geometry_on(s, device)
        lbox = TH.letterbox_inverse_params(hws_, s.in_hw).contiguous()
        kw = dict(classes=s.class_num, max_out=30, iou_thresh=IOU)
        plain = lambda: TH._decode_and_select(  # noqa: E731
            p, geom, lbox, class_softmax=False, stop_below=0.7, **kw)
        kern = lambda: TH._launch(  # noqa: E731
            p, geom, lbox, score_thresh=0.7, class_softmax=False, **kw)
        p1, k1, k2, p2 = (time_ms(plain, 5), time_ms(kern, 20),
                          time_ms(kern, 20), time_ms(plain, 5))
        head_times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        # ... and the whole head call, wrapper ops included
        call_k = time_ms(lambda: TH.fused_decode_nms(
            preds, s, hws_, 0.7, IOU, 30), 20)
        call_p = time_ms(lambda: TH.fused_decode_nms_reference(
            preds, s, hws_, 0.7, IOU, 30), 5)
        print(f"head b{BATCH} {name:<6}: kernel {k1:.4f}/{k2:.4f} ms, plain "
              f"{p1:.4f}/{p2:.4f} ms; whole call {call_k:.4f} ms, plain "
              f"call {call_p:.4f} ms {tag}")

    # ---- 6. where the device time goes ----------------------------------
    for label, fn, wall_ms in (
            (f"b{BATCH}", lambda: pred._run_batch(c_dev, h_dev), serve_ms),
            ("b1", lambda: pred._run_batch(c_dev[:1], h_dev[:1]), b1_ms)):
        n_kernels, dev_ms, by_cat, top = kernel_profile(fn, iters=5)
        if n_kernels == 0:
            print(f"profile {label}: the profiler recorded no device events; "
                  f"device time not measured {tag}")
            continue
        cats = ", ".join(f"{k} {v:.3f} ms" for k, v in by_cat.items())
        print(f"profile {label} sparse: {n_kernels:g} kernels/call, device "
              f"{dev_ms:.3f} ms/call of {wall_ms:.3f} ms timed (busy share "
              f"{dev_ms / wall_ms:.3f}); {cats} {tag}")
        for name, ms, count in top:
            print(f"  {ms:8.3f} ms  x{count:<4g} {name[:100]}")

    k_ms, p_ms = head_times["slice"]
    print(json.dumps({"kernels": [{
        "name": "yolo_head_decode_nms",
        "route": "cuda",
        "source": "k210_yolo_framework_tpu_torch/csrc/yolo_head.cu",
        "replaces": "k210_yolo_framework_tpu/ops/yolo_head_pallas.py:140",
        "launches": launches,
        "max_abs_err": max(max_err, slice_err),
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

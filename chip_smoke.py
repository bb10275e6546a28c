#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and eval paths, and each of
its five CUDA kernels on the path that runs it, once on one NVIDIA GPU;
then the three other builders served and trained (phase 15), the
command-line entry points (phase 16), quantized serving, the export and
the ``Helper`` facade (phase 17), and the darknet53 yolo at 608x608 with
the greedy kernels' global path, the stem modes and data-parallel serving
(phase 18), data-parallel training (phase 19), serving and training on
the model and space axes (phase 20: yolo_mobilev1; phase 21: the other
three builders), quantized and patches serving on those axes (phase 22),
the benchmark program and the entry contracts (phase 23), and the conv
epilogue on the served nets, YOLOv4's Mish and its head's ``scale_x_y``
among them (phase 24).

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

  1. device: requires ``torch.cuda.is_available()``; prints the card's name
     and power limit as nvidia-smi reports them;
  2. build: compiles the port's CUDA kernels from the sources in this
     checkout (``k210_yolo_framework_tpu_torch/csrc/yolo_head.cu``,
     ``rotate3shear.cu``, ``nms.cu``, ``dwsep.cu`` and
     ``conv_epilogue.cu``; the first and third
     share ``greedy_select.cuh``, the selection loop that runs a class row
     in one warp over a list of its live candidates), one nvcc each,
     started together, prints
     ptxas's registers per kernel, and counts the HMMA (tensor-core)
     instructions in the SASS of the bf16 dwsep kernel (``cuobjdump``
     beside that nvcc): none fails the run;
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
     latency, and the head kernel against its plain version at batch 128
     (threshold 0.7, max_out 30) and at the eval settings on the served
     net's logits (batch 32, threshold 0.01, max_out 100), with G (the
     class rows a block) and the live candidate tests of each; the head
     kernel also on the card alone, its launches queued ahead
     (``device_ms``);
  6. where the device time goes: torch.profiler kernel events (each kernel
     once) of one serving call at batch 128 and at batch 1;
  7. the rotation against its plain PyTorch version on the card, both
     through the public ``rotate_3shear`` / ``rotate_3shear_reference`` and
     kernel against plain arithmetic on the same tables: 42 images of
     224x320x3 in fp32 and in bf16 (the train batch's rotate slice at
     B=128) and 6 of 96x96x3, at thetas U(-10, 10) degrees plus exactly
     +-10 degrees, 0 and +-1e-4 rad;
  8. the train slice: 256 synthetic JPEGs (20 classes, written once for
     phases 8, 9 and 13) through the default ``DataPipeline`` at batch 128
     on 512x512 canvases (it prints which loader that picked: the native
     C++ loader where ``csrc/loader.cpp`` builds, else the PIL threads, and
     then the compiler's first error line and ``use_native=True``'s
     refusal), and ``fit`` of a
     seeded yolo_mobilev1 (alpha 0.75, VOC spec) in bf16 with augment on,
     for one epoch of 3 train steps and 1 validation step.  The rotation
     kernel must run once per train step, every logged scalar be finite,
     and the parameters and BN running statistics move.  Then 30 steps on
     one fixed preprocessed batch (the loss must fall); and at B=8 in
     fp32, the preprocess of one HostBatch with the same augment draws on
     the card against the CPU, and train steps on the card against the
     same steps on the CPU: a witness with smooth activations (every
     gradient within GRAD_TOL), the activations alone (bit for bit), and
     the net as trained (see GRAD_TOL);
  9. times: train preprocess and step at batch 128 in bf16 with the
     HostBatch on the card, both host loaders' rates (native and PIL
     threads), the rotation kernel against its plain version at N=42 in
     bf16 and fp32 (by events and on the card alone, with ptxas's
     registers, the tile and its shared memory), and a kernel profile of
     one train step;
 10. NMS alone (``batched_nms_pallas``, ``csrc/nms.cu``) against its plain
     version bit for bit, on phase 3's cases decoded by ``decode_outputs``,
     both score flavours, at max_out 30 and at max_out 100 / threshold 0.01;
 11. the two-stage head on the slice: ``decode_outputs`` ->
     ``batched_nms_pallas`` on each phase-4 scene's own bf16 logits at
     B=128 (the NMS kernel must run once per call), against the fused head
     kernel on the same logits (phase 3's tolerances, and as sets) and
     against the export program's ``ops/nms.batched_nms`` at top_k = N;
 12. the fused dw-separable block (``fused_dwsep``, ``csrc/dwsep.cu``) on
     the nine stride-1 blocks of the served net: each block's input from
     the B=128 bf16 serving forward, its BN folded; the kernel (once per
     block) against ``fused_dwsep_reference`` and against the block's own
     output (0.05), then at B=8 in fp32 against the plain version (2e-5);
     a NaN put into the first and the last block's input gives NaN at the
     same outputs in the kernel and the plain version;
 13. VOC eval: ``eval.collect_detections`` / ``match_detections`` of a bf16
     Predictor over the JPEGs at obj_thresh 0.01, iou_thresh 0.45,
     max_out 100, batch 32 on 512x512 canvases (one head launch per batch,
     a finite mAP, well-formed detections), its imgs/s with host staging,
     and 8 images in fp32, card against CPU;
 14. times: NMS alone on the three scenes and the fused block on each of
     the nine blocks, each against its plain version (plain, kernel,
     kernel, plain; NMS also by ``device_ms``); beside the fused block,
     the served net's own block (two cuDNN convs, each with its conv
     epilogue; bf16 output) and a bf16 cuDNN pair with BN folded, on the
     same input;
 15. the builders: yolo_mobilev2 (alpha 0.75), tiny_yolo and the darknet53
     yolo (three scales, 4,410 candidates), seeded, at 224x320.  Each is
     served in bf16 at B=128 through ``predict_batch`` (0.7 and dense-bias
     scenes) and ``predict_image``: one head launch per call, detections
     against the plain head on the same logits, serve imgs/s, batch-1
     latency and a kernel profile.  Each is trained by ``fit`` for 3 steps
     in bf16 with augment on at B=128 (or the largest of 64 and 32 that
     fits): one rotation launch a step, finite scalars, parameters and BN
     statistics moved (yolo_mobilev2: one step moves a running mean by
     exactly 0.999 r + 0.001 batch), train imgs/s and peak memory; then one
     fp32 step at B=2, 96x128, card against CPU as in phase 8.  Last, the
     head kernel on the served yolo's own logits at B=128 (0.7 and dense)
     and at the eval settings (B=32, 0.01, max_out 100) against its plain
     version and bound, and the layout each builder's rows take at three
     input sizes (shared, own or global; none refused).  Each part prints
     its wall seconds;
 16. the entry points, run in this process on phase 8's JPEGs in a working
     directory laid out as they expect: ``cli.make_anchor_list``, then
     ``cli.keras_train`` (yolo_mobilev1 alpha 0.75, b64 bf16, augment on,
     pruned to 0.9 by the schedule's end, ``--profile``,
     ``--bn_recalibrate 2``): one rotation launch per train step, every
     large kernel of the saved ``yolo_prune_model.npz`` at the target
     sparsity, scalars and events at the same steps, a trace naming
     ``rotate_kernel``; again with ``--pre_ckpt`` (the step count goes
     on); ``update_masks`` on the card against the CPU mask for mask;
     ``cli.keras_inference`` (bf16, one head launch) printing
     ``Predictor.predict_image``'s table row for row; ``cli.keras_eval``
     at its defaults (one head launch a batch) giving ``evaluate_map``'s
     mAP; and the B=128 train step with pruning off, updating the masks
     and applying them;
 17. quantized serving: phase 4's net at B=128 bf16 in each of the five
     modes (none, int8, int8_act, int8_act_sym, int8_act_cal, the last
     calibrated by ``eval.calibrate_from_rows`` on 32 of phase 8's JPEGs)
     on the 0.7, mid and dense scenes: one head launch a call, imgs/s,
     b1 latency, a kernel profile and the bytes of the weights held on
     the card; on each scene the head kernel against the plain head on
     the same B=128 logits (``compare_heads``); each int8 product
     (``torch._int_mm``) of an int8-activation forward at B=8, card
     against CPU exactly; each mode's detections at B=8 fp32 against the
     CPU at set level; the match rate of each quantized mode's boxes
     against the unquantized ones (IoU >= 0.7, score within 0.1; a
     finding).  tiny_yolo and the darknet53 yolo in int8_act and
     int8_act_cal at B=32 (the zp-padded SAME 3x3 convs), yolo_mobilev2
     in int8 and int8_act (124-channel convs: the zero-padded int8
     product) at B=128, against the plain head.  ``yolo_serving.pt2`` of
     the bf16 and the int8 Predictor on the 0.7 and the mid scene, saved,
     loaded and run on the card (in b8 programs) against the live
     Predictor at set level, with its rate and size.  In process on phase 16's checkpoint:
     ``cli.keras_freeze`` (its serving program equal to the Predictor's),
     ``cli.keras_inference --quantize int8_act_cal`` (the table of
     ``predict_image``) and ``cli.keras_eval --quantize int8 --calib_list``
     (``evaluate_map``'s mAP).  ``compat.Helper``: one batch of
     ``set_dataset`` on the card, and ``_process_img(is_training=True)``
     with a rotation drawn (one rotation launch);
 18. the darknet53 yolo at YOLOv3's 608x608 (N=22,743, past what a block's
     shared memory holds: the head and NMS kernels' rows in global
     scratch), seeded: served in bf16 at B=8 through ``predict_batch`` and
     ``predict_image`` in the 0.7, mid and dense scenes (the head on its
     global path once per call, against the plain head on the same
     logits), its rate, fp32 card against the port on the CPU at B=2 as
     sets; the head kernel and the two-stage NMS kernel on each scene's
     logits against their plain versions (NMS bit for bit) with times,
     bounds and scratch bytes, and both at N=72,828 (1088x1088, B=1, past
     16-bit indices); ``cli.keras_inference`` and one ``cli.keras_eval``
     batch at ``--image_size 608 608 --output_size 19 19 38 38 76 76``.
     The stem modes: yolo_mobilev1 (alpha 0.75) in ``default``,
     ``patches`` and ``nativeconv`` and yolo_mobilev2 in ``default`` and
     ``patches``, at B=128 bf16 on the mid scene: each mode's input
     against ``unfold`` of the default letterbox's canvas, its detections
     against the default's as sets, one head launch a call, imgs/s, b1
     latency and a kernel profile; then yolo_mobilev1 under
     ``int8_act_cal`` in ``default`` and ``nativeconv``, calibrated (the
     3-channel stem int8 with its own range in ``nativeconv``): the head
     kernel against the plain head on its logits, imgs/s, and each int8
     conv, the stem among them, with its int8 product card against CPU
     exactly.  Data-parallel serving:
     ``make_sharded_runner(make_mesh())`` over a world-size-1 NCCL group at
     B=128, bit for bit against ``_run_batch``, and its rate (one GPU: no
     multi-GPU number);
 19. training on the data axis over a world-size-1 NCCL group (one GPU:
     no multi-GPU number): ``fit(mesh=make_mesh())`` against ``fit``, 3
     steps of yolo_mobilev1 (alpha 0.75) at B=128 in bf16 with augment on
     and 1 validation step, same weights, generator and host batches,
     cuDNN deterministic: parameters, BN running statistics, Adam moments
     and logged scalars bit for bit (or, with the differing tensors
     printed, within 10x a batch-permutation control), one rotation launch
     a step; the mesh step against the plain step on one preprocessed
     batch (CUDA events, plain, mesh, mesh, plain) with a kernel profile
     of each and the NCCL share; ``cli.keras_train --mesh auto`` in
     process for 2 steps (one rotation launch a step, its checkpoint);
 20. the model and space axes (channel tensor parallelism and H-row
     spatial partitioning), yolo_mobilev1 (alpha 0.75, seeded) at 224x320
     on tp2, sp2 (2 processes) and tp2*sp2 (4 processes).  NCCL refuses
     two ranks on one card, so each world is joined by gloo with the
     tensors on CUDA.  Each rank: ``make_sharded_runner`` in fp32 at B=32
     against ``_run_batch`` on the card (at most 0.5% unmatched either way,
     matched scores within 1e-3) and in bf16 at B=128 on the mid scene at
     set level (1%, 0.02; the flip rate printed), one head launch a call;
     3 ``make_train_step`` steps in fp32 at B=32 against the plain step
     (step-1 loss rtol 1e-5, first-step gradients and parameters within
     10x a batch-permutation control taken on the card) and one fused
     bf16 step at B=128 with augment on (one rotation launch); its serve
     and step ms (gloo on one card: not a scaling number) and its
     collectives a step.  Then ``keras_train --mesh 1,2`` must refuse the
     one-card machine;
 21. the other builders on the model and space axes, in phase 20's
     worlds (each world spawned once for both phases, one row of
     ``TPSP_CASES`` a builder): yolo_mobilev2 (alpha 1.0) and tiny_yolo
     at 224x320, the darknet53 yolo at 224x320 and at 608x608
     (N=22,743), seeded.  Each rank: ``make_sharded_runner`` in fp32
     against ``_run_batch`` (at most 0.5% unmatched either way, matched
     scores within 1e-3), one head launch a call (on the global path at
     608x608); for the first three, 2 ``make_train_step`` steps in fp32
     of the smooth witness against the plain step (step-1 loss rtol
     1e-5, first-step gradients and parameters within 10x a
     batch-permutation control, worst leaf outside the leaves whose
     gradient is at rounding level, which must stay there) and one step
     of the net itself (step-1 loss rtol 1e-5); tiny_yolo's fused bf16
     step at B=32 (one rotation launch) and, in the 4-rank world, its
     ``recalibrate_batch_stats(mesh=)`` on dp2*sp2 and tp2*sp2 against
     the single-process recalibration; the serve and step ms (gloo on one
     card: not a scaling number) and the collectives a step;
 22. quantized and patches serving on the model and space axes, in phase
     20's worlds after the cases of phases 20-21: yolo_mobilev1 (alpha
     0.75) at 224x320 through ``make_sharded_runner`` in fp32 at B=32 in
     ``int8``, ``patches`` and ``patches`` + ``int8`` (at most 0.5%
     unmatched either way, matched scores within 1e-3), ``int8_act``,
     ``int8_act_sym``, ``int8_act_cal`` (calibrated on the scene's
     canvases) and ``nativeconv`` under ``int8_act`` (at most 1% and
     2e-3, the CPU tests' pinned flip bound), each against the same
     Predictor's ``_run_batch`` on the card; yolo_mobilev2 in ``patches``
     and tiny_yolo and the darknet53 yolo in ``int8_act`` at phase 21's
     batches.  Each rank: one head launch a call, the weight bytes it
     holds equal to the single-process Predictor's (the weights stay
     whole), the activation ranges' all-reduces in a call (none in
     ``int8``, ``int8_act_cal`` and the float stems) and the ms of a call
     (gloo on one card: not a scaling number);
 23. the benchmark program ``k210_yolo_framework_tpu_torch.bench`` in this
     process at its own settings: ``--mode all`` (serve, serve512,
     serve_int8, serve_scan, loader, train, train_e2e) and the five modes
     it leaves out (serve_dual, serve_dense, serve_int8act[_sym|_cal]),
     each line parsed and held to its metric, the card's name, power limit
     and count; ``serve_scan`` must have run as a captured CUDA graph and
     ``serve_dense`` must have filled every class list (its own check);
     the head kernel launched and the rotation kernel once a train_e2e
     step; ``serve`` printed beside phase 5's imgs/s, ``train`` and
     ``train_e2e`` beside phase 9's step and fused step.  Then
     ``entry.entry()`` on the card against the same forward on the CPU
     (fp32, rtol and atol 1e-5, on the contract's zeros and on uniform
     images) and ``entry.dryrun_multichip`` on the card: 8 ranks (gloo
     processes sharing the card) and 1 (NCCL);
 24. the conv epilogue (``ops.conv_epilogue``, ``csrc/conv_epilogue.cu``)
     on the benchmark's served shapes: yolo_mobilev1 (alpha 0.75) at
     224x320, B=128, and the darknet53 yolo and YOLOv4 at 608x608, B=32,
     bf16, every BatchNorm drawn.  One ``predict_batch`` each, the launch
     count zeroed just before it: one launch per ConvBN (30, 72 and 107,
     YOLOv4's 72 Mish calls among them), each leaky, ReLU and linear
     call's output bit for bit ``conv_epilogue_reference``'s on its
     arguments and each Mish call's within 8 fp32 ulps (plus one bf16 ulp
     for a bf16 store); then all of a forward's calls timed against their
     plain versions and the bytes bound, the profiler's tie of each kernel
     to its ``k210::conv_epilogue`` op (every one must hold its kernel; 72
     ``epilogue_mish_kernel`` for YOLOv4), and the wrapper's host
     microseconds a call.  YOLOv4's head, with the net's ``scale_x_y``
     taken by the ``Predictor``, on the served logits at the eval settings
     (global path): the kernel bit for bit its plain version
     ``_decode_and_select``, and timed.

Beside every kernel time the script prints the bound it computes from the
same inputs: the larger of the bytes the kernel must move over HBM's rate
and its operations over the card's peak rate for their type (``bound``).
Greedy NMS counts only the candidates each step has to test.

The next-to-last line is one JSON object describing each kernel (``ms``
by CUDA events; the head, the rotation and NMS also carry ``device_ms``;
the head and NMS also their launches and times on the global path; the
epilogue its 608x608 times under ``yolo608`` and ``yolov4``, the
latter with its Mish figures and its head under ``head``);
the last
line is ``{"ok": true, "device": {...}}``.  Nothing of JAX is imported: the
script imports only the port, which imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

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


def sass_hmma_count(lib_path, kernel: str) -> int:
    """HMMA instructions in the SASS of the functions of ``lib_path`` whose
    mangled name holds ``kernel``, by ``cuobjdump -sass`` from the bin/ of
    the nvcc that builds the kernels."""
    from k210_yolo_framework_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    funcs = [f for f in sass.split("Function : ")[1:]
             if kernel in f.splitlines()[0]]
    if not funcs:
        raise AssertionError(f"no function {kernel} in the SASS of "
                             f"{Path(lib_path).name}")
    return sum(line.count("HMMA") for f in funcs for line in f.splitlines())


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


def device_ms(fn, iters: int, cycles: int = 1 << 24) -> float:
    """Mean time of one call of ``fn`` on the card alone: a spin kernel
    holds the stream while the host queues ``iters`` calls, and CUDA events
    around the calls then time their launches back to back, without the
    host's launch path that events around a short kernel's calls also
    measure.  Counts only where the host had queued every call before the
    spin ended (else the spin is doubled, up to 4 tries) and raises if it
    never had."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued = not start.query()      # the spin still running
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / iters
        cycles *= 2
    raise AssertionError(f"the host did not queue {iters} calls within a "
                         f"spin of {cycles // 2} cycles")


KERNEL_CATEGORIES = (
    ("nccl", ("nccl",)),
    ("head kernel", ("yolo_head",)),
    ("rotate kernel", ("rotate_kernel",)),
    ("epilogue kernel", ("epilogue_kernel",)),
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
    by_cat = {"head kernel": 0.0, "rotate kernel": 0.0,
              "epilogue kernel": 0.0, "conv/matmul": 0.0,
              "nccl": 0.0, "elementwise/other": 0.0, "memcpy/memset": 0.0}
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


ROT_N = 42            # the rotate slice of a stratified batch of 128
TRAIN_BATCH = 128
FIXED_STEPS = 30
# card against CPU at B=8 in fp32 (TF32 off).  Preprocess: the letterbox
# truncates to whole levels, so a sum that rounds the other way moves a
# pixel by one level (1/255 of an image whose peak is 255; allowed up to
# 1/64) in at most 1% of the pixels.  Train step, on the same preprocessed
# batch: losses rtol 1e-4.  Gradients, each parameter's error taken as its
# largest difference over its largest entry:
# * the witness: the same net, weights and batch with a * x + (1 - a) *
#   softplus(x) in place of every ReLU (a = 0) and LeakyReLU(a), held to
#   GRAD_TOL flat for every parameter, the tolerance the CPU tests hold the
#   port's gradients to JAX's with.  It runs every other op of the step,
#   forward and backward (measured on an H100: 2.3e-5 at worst);
# * the kinks themselves: ReLU and LeakyReLU forward and backward on the
#   card, bit for bit against the CPU, on values that include zeros;
# * the net as trained, kinks and all: its backbone and DarknetConvBN
#   gradients are ill-conditioned at init.  On the CPU alone, moving every
#   input pixel by one fp32 ulp, or summing on 1 thread instead of 8, moves
#   some of them by 1.5-10% of their largest entry; the smooth witness
#   moves by 3e-5 under the same noise.  So each parameter is held to
#   GRAD_TOL + ENVELOPE x the CPU's own spread under NOISE_DRAWS one-ulp
#   input perturbations, and never to more than GRAD_CAP.
#   A parameter whose exact gradient is 0 (yolo_mobilev2's project BN
#   biases: a 1x1 conv and a train-mode BN follow them and remove any
#   per-channel shift) is instead held below VANISH of the net's largest
#   gradient entry on both sides: its rounding noise has no scale of its
#   own to be compared against.
PIXEL_TOL, PIXEL_SHARE = 1.0 / 64, 0.01
STEP_RTOL, GRAD_TOL, ENVELOPE, NOISE_DRAWS, GRAD_CAP = 1e-4, 1e-3, 2.0, 3, 0.1
VANISH = 1e-4


def rotate_mismatch(got, want, dtype):
    """(max abs difference, elements outside the tolerance): fp32 rtol
    1e-6 / atol 1e-4, bf16 one ulp of the plain value."""
    import torch

    g, w = got.float(), want.float()
    d = (g - w).abs()
    if dtype == torch.float32:
        limit = 1e-4 + 1e-6 * w.abs()
    else:
        limit = torch.where(
            w == 0, torch.full_like(w, 2.0 ** -133),
            torch.exp2(torch.floor(torch.log2(w.abs())) - 7))
    return float(d.max()), int((d > limit).sum())


def rotate_phase(device) -> float:
    """Phase 7: the rotation kernel against its plain version on the same
    tables; returns the largest absolute difference."""
    import torch

    from k210_yolo_framework_tpu_torch.ops import rotate_pallas as TR

    rng = np.random.default_rng(3)
    max_err = 0.0
    for n, h, w, dtype in ((ROT_N, 224, 320, torch.float32),
                           (ROT_N, 224, 320, torch.bfloat16),
                           (6, 96, 96, torch.float32),
                           (6, 96, 96, torch.bfloat16)):
        imgs = torch.from_numpy(rng.uniform(0, 255, (n, h, w, 3)).astype(
            np.float32)).to(device).to(dtype)
        th = np.deg2rad(rng.uniform(-10, 10, n)).astype(np.float32)
        th[:5] = [np.deg2rad(10.0), -np.deg2rad(10.0), 0.0, 1e-4, -1e-4]
        thetas = torch.from_numpy(th).to(device)
        tables = TR.shear_tables(thetas, h, w, dtype)
        # the public wrapper (tables made on the card, then the kernel)
        # against the public plain version, on the same card tensors; and
        # the kernel alone against the plain arithmetic on the same tables
        for what, got, want in (
                ("rotate_3shear vs rotate_3shear_reference",
                 TR.rotate_3shear(imgs, thetas),
                 lambda: TR.rotate_3shear_reference(imgs, thetas)),
                ("kernel vs plain, same tables", TR._launch(imgs, tables),
                 lambda: TR._rotate_plain(imgs, tables))):
            torch.cuda.synchronize()
            want = want()
            err, bad = rotate_mismatch(got, want, dtype)
            n_diff = int((got != want).sum())
            print(f"{what}: N={n} {h}x{w}x3 {str(dtype).split('.')[-1]}: "
                  f"max_abs_err={err:.3g} elements_differing={n_diff} "
                  f"outside_tolerance={bad}")
            if bad or got.dtype != dtype or got.shape != imgs.shape:
                raise AssertionError("rotate kernel disagrees with its plain "
                                     "version")
            if not torch.equal(got[2], imgs[2]):
                raise AssertionError("rotate kernel: theta 0 is not the "
                                     "identity")
            max_err = max(max_err, err)
    return max_err


def activations_card_vs_cpu(device) -> None:
    """ReLU, LeakyReLU(0.1, 0.3) and ReLU6 with gradients on, forward and
    backward, on the card against the CPU bit for bit."""
    import torch

    from k210_yolo_framework_tpu_torch.models import layers as TL

    gen = torch.Generator().manual_seed(4)
    x = torch.randn(8, 64, 28, 40, generator=gen) * 4
    x[:, :, ::7] = 0.0
    x[:, :, 1::7] = -0.0
    x[:, :, 2::7] = 6.0
    g = torch.randn(x.shape, generator=gen)
    for name, act in (("relu", TL.relu), ("leaky_relu(0.1)", TL.leaky_relu(0.1)),
                      ("leaky_relu(0.3)", TL.leaky_relu(0.3)),
                      ("relu6", TL.relu6)):
        res = []
        for dev in (device, torch.device("cpu")):
            xx = x.to(dev).clone().requires_grad_()
            y = act(xx)
            y.backward(g.to(dev))
            res.append((y.detach().cpu(), xx.grad.cpu()))
        (y_card, g_card), (y_cpu, g_cpu) = res
        same = torch.equal(y_card, y_cpu) and torch.equal(g_card, g_cpu)
        print(f"activation card vs CPU: {name} forward and backward on "
              f"{x.numel()} values ({int((x == 0).sum())} zeros): "
              f"{'bit-identical' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError(f"{name}: card and CPU differ")


def card_vs_cpu_step(device, spec, cfg, init_net, host, grad_cap=GRAD_CAP,
                     vanishing=(), noise=2.0 ** -23):
    """Phase 8c: the fp32 preprocess of one HostBatch with the same augment
    draws on the card and on the CPU; then fp32 train steps on each from
    the same weights and the same (the card's) preprocessed batch: the
    smooth witness, the activations alone, and the net as trained with
    NOISE_DRAWS more CPU steps from one-ulp perturbations of the batch,
    which measure how far its gradients move under rounding alone."""
    import copy
    import dataclasses

    import torch

    from k210_yolo_framework_tpu_torch.data import pipeline as PL
    from k210_yolo_framework_tpu_torch.models.layers import smooth_witness
    from k210_yolo_framework_tpu_torch.ops import augment as TA
    from k210_yolo_framework_tpu_torch.training import train as TT

    b = host.canvases.shape[0]
    cfg_b = dataclasses.replace(cfg, batch_size=b)
    params = TA.draw_params(b, spec.in_hw,
                            generator=torch.Generator().manual_seed(2))
    pp = PL.make_preprocess_fn(spec, True)
    with torch.no_grad():
        images, labels = pp(*host.to(device), params=params)
        cpu_images, cpu_labels = pp(*host.to("cpu"), params=params)
    d = (images.cpu() - cpu_images).abs()
    share = float((d > 1e-3).float().mean())
    lab_err = max(float((a.cpu() - b_).abs().max())
                  for a, b_ in zip(labels, cpu_labels))
    print(f"preprocess card vs CPU (B={b}, fp32): images max_abs_err "
          f"{float(d.max()):.3g}, {share:.2e} of them above 1e-3; labels "
          f"max_abs_err {lab_err:.3g}")
    if float(d.max()) > PIXEL_TOL or share > PIXEL_SHARE or lab_err > 1e-6:
        raise AssertionError("card and CPU preprocess differ")

    cpu = torch.device("cpu")

    def one_step(net, dev, imgs):
        state = TT.create_train_state(copy.deepcopy(net), cfg_b, dev)
        state, logs = TT.make_train_step(spec, cfg_b)(
            state, imgs.to(dev), [lab.to(dev) for lab in labels])
        return logs, {n: p.grad.cpu() for n, p in
                      state.net.named_parameters()}

    def grad_err(got, want):
        return {n: float((got[n] - g).abs().max())
                / max(float(g.abs().max()), 1e-30) for n, g in want.items()
                if not n.endswith(vanishing)}

    def zero_grads(what, card, ref):
        # parameters whose exact gradient is 0: both sides below VANISH of
        # the net's largest gradient entry
        names = [n for n in ref if n.endswith(vanishing)]
        if not names:
            return
        top = max(float(g.abs().max()) for g in ref.values())
        worst = max(max(float(card[n].abs().max()), float(ref[n].abs().max()))
                    for n in names) / top
        print(f"train step card vs CPU ({what}): the {len(names)} gradients "
              f"that vanish ({', '.join(vanishing)}) reach {worst:.2e} of "
              f"the largest gradient entry, against {VANISH}")
        if worst > VANISH:
            raise AssertionError(f"{what}: a vanishing gradient does not")

    def same_losses(what, card_logs, cpu_logs):
        for k in ["loss"] + [f"l{l + 1}_loss" for l in range(len(labels))]:
            a, b_ = float(card_logs[k]), float(cpu_logs[k])
            print(f"train step card vs CPU (B={b}, fp32, {what}): {k} "
                  f"{a:.6f} vs {b_:.6f} (rel {abs(a - b_) / abs(b_):.2e})")
            if abs(a - b_) > STEP_RTOL * abs(b_):
                raise AssertionError(f"{what} {k}: card and CPU differ")

    # the witness: smooth activations, every gradient at GRAD_TOL
    smooth = smooth_witness(init_net)
    card_logs, card = one_step(smooth, device, images)
    cpu_logs, ref = one_step(smooth, cpu, images)
    same_losses("smooth witness", card_logs, cpu_logs)
    zero_grads("smooth witness", card, ref)
    errs = grad_err(card, ref)
    worst = sorted(errs, key=errs.get, reverse=True)
    print(f"train step card vs CPU (smooth witness): gradient error (max "
          f"difference over the CPU gradient's largest entry) at most "
          f"{errs[worst[0]]:.2e} against {GRAD_TOL} flat, {len(errs)} "
          f"parameters; worst 3: "
          + ", ".join(f"{n} {errs[n]:.2e}" for n in worst[:3]))
    if errs[worst[0]] > GRAD_TOL:
        raise AssertionError("smooth witness: gradients differ between card "
                             "and CPU")
    activations_card_vs_cpu(device)

    # the net as trained
    card_logs, card = one_step(init_net, device, images)
    cpu_logs, ref = one_step(init_net, cpu, images)
    same_losses("as trained", card_logs, cpu_logs)
    noise_gen = torch.Generator().manual_seed(9)
    cpu_images = images.cpu()
    zero_grads("as trained", card, ref)
    spread = dict.fromkeys(grad_err(ref, ref), 0.0)
    for _ in range(NOISE_DRAWS):
        noisy = cpu_images * (1 + noise * torch.randn(
            cpu_images.shape, generator=noise_gen))
        for n, e in grad_err(one_step(init_net, cpu, noisy)[1], ref).items():
            spread[n] = max(spread[n], e)
    errs = grad_err(card, ref)
    limit = {n: min(GRAD_TOL + ENVELOPE * spread[n], grad_cap) for n in errs}
    rows = sorted(((errs[n] / limit[n], n) for n in errs), reverse=True)
    loose = [n for n in errs if limit[n] > 2 * GRAD_TOL]
    print(f"train step card vs CPU (as trained): gradient error against "
          f"min({GRAD_TOL} + {ENVELOPE} x CPU spread under {NOISE_DRAWS} "
          f"input perturbations of {noise:.2g} relative, {grad_cap}); "
          f"{len(loose)} of "
          f"{len(rows)} parameters held looser than {2 * GRAD_TOL} (limits "
          f"up to {max(limit.values()):.3g}, "
          f"{sum(limit[n] == grad_cap for n in errs)} at the cap); worst 3: "
          + ", ".join(f"{n} {errs[n]:.2e} (spread {spread[n]:.2e}, "
                      f"{r:.2f} of limit)" for r, n in rows[:3]))
    out = [n for n in errs if ".dark_conv_out." in n]
    print(f"train step card vs CPU (as trained): largest gradient error "
          f"{max(errs.values()):.2e} (the {len(out)} output-conv parameters: "
          f"{max(errs[n] for n in out):.2e}), largest CPU spread "
          f"{max(spread.values()):.2e} (output convs: "
          f"{max(spread[n] for n in out):.2e})")
    if rows[0][0] > 1.0:
        raise AssertionError("gradients differ between card and CPU")


def loader_rate(pl, ann, use_native: bool) -> float:
    """imgs/s of ``DataPipeline(use_native=...)`` over 8 batches of
    TRAIN_BATCH on 512x512 canvases, after one batch of warm-up."""
    it = iter(pl.DataPipeline(ann, TRAIN_BATCH, seed=5,
                              use_native=use_native))
    try:
        next(it)
        t0 = time.perf_counter()
        for _ in range(8):
            next(it)
        return 8 * TRAIN_BATCH / (time.perf_counter() - t0)
    finally:
        it.close()


def ptxas_lines(log: str, kernel: str) -> list:
    """ptxas's register / shared-memory / spill lines of the functions of
    ``log`` whose mangled name holds ``kernel``."""
    out, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            keep = kernel in line
        if keep and any(k in line for k in ("registers", "smem", "spill")):
            out.append(line.strip())
    return out


def train_phases(device, tag, ann, rot_log):
    """Phases 7-9 on the synthetic JPEGs of ``ann``; ``rot_log`` is the
    rotation kernel's build log.  Returns the rotation kernel's JSON
    fields, and phase 9's train step and fused step ms."""
    import copy

    import torch

    from k210_yolo_framework_tpu_torch import native, voc_spec
    from k210_yolo_framework_tpu_torch.config import TrainConfig
    from k210_yolo_framework_tpu_torch.data import pipeline as PL
    from k210_yolo_framework_tpu_torch.data.annotations import (
        split_train_test,
    )
    from k210_yolo_framework_tpu_torch.models import build_network
    from k210_yolo_framework_tpu_torch.ops import rotate_pallas as TR
    from k210_yolo_framework_tpu_torch.training import train as TT

    # ---- 7. rotation kernel against its plain version -------------------
    rot_err = rotate_phase(device)

    # ---- 8. the train slice ---------------------------------------------
    spec = voc_spec()
    cfg = TrainConfig(batch_size=TRAIN_BATCH, max_epochs=1, augment=True)
    train_ann, test_ann = split_train_test(ann, 0.5)
    # the loader fit runs on is the default one: the C++ loader where it
    # builds, as in the JAX package; else the PIL threads, and then
    # use_native=True must refuse rather than fall back
    train_pl = PL.DataPipeline(train_ann, TRAIN_BATCH, seed=0)
    if train_pl.use_native:
        print("loader: the default DataPipeline picked the native C++ "
              "loader")
    else:
        print(f"loader: the default DataPipeline picked the PIL threads; "
              f"the native build failed: {native.build_error()}")
        try:
            next(iter(PL.DataPipeline(train_ann, 2, 0, use_native=True)))
        except RuntimeError as e:
            print(f"loader: use_native=True raises: {e}")
        else:
            raise AssertionError("use_native=True ran without the native "
                                 "library")
    train_it = iter(train_pl)
    test_it = iter(PL.DataPipeline(test_ann, TRAIN_BATCH, seed=1))
    net = build_network("yolo_mobilev1", spec.in_hw, spec.nanchors,
                        spec.class_num, alpha=0.75,
                        generator=torch.Generator().manual_seed(0))
    init_net = copy.deepcopy(net)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    pp_train = PL.make_preprocess_fn(spec, cfg.augment, torch.bfloat16)
    pp_test = PL.make_preprocess_fn(spec, False, torch.bfloat16)
    scalars = []

    TR.rotate_3shear.launches = 0
    state = TT.fit(net, spec, cfg, train_it, test_it, pp_train, pp_test,
                   3, 1, device=device,
                   generator=torch.Generator().manual_seed(cfg.rand_seed),
                   compute_dtype=torch.bfloat16,
                   log_fn=lambda line: print(f"  fit: {line}"),
                   scalar_logger=lambda s, d: scalars.append((s, d)))
    torch.cuda.synchronize()
    rot_launches = TR.rotate_3shear.launches
    print(f"train slice: rotate kernel launches {rot_launches} in 3 "
          f"train steps")
    if rot_launches != 3:
        raise AssertionError("the rotate kernel did not run once per "
                             "train step")
    if [s for s, _ in scalars] != [1, 2, 3] or not all(
            np.isfinite(v) for _, d in scalars for v in d.values()):
        raise AssertionError(f"logged scalars: {scalars}")
    after = net.state_dict()
    moved = {kind: [not torch.equal(after[k].cpu(), before[k])
                    for k in before if k.endswith(suffix)]
             for kind, suffix in (("params", ("weight", "bias")),
                                  ("BN running stats",
                                   ("running_mean", "running_var")))}
    for kind, flags in moved.items():
        print(f"train slice: {sum(flags)} of {len(flags)} {kind} moved")
        if not all(flags):
            raise AssertionError(f"some {kind} did not move")

    hb = next(train_it).to(device)
    with torch.no_grad():
        images, labels = pp_train(
            *hb, generator=torch.Generator().manual_seed(1))
    step = TT.make_train_step(spec, cfg, torch.bfloat16)
    losses = []
    for _ in range(FIXED_STEPS):
        state, logs = step(state, images, labels)
        losses.append(logs["loss"])
    losses = torch.stack(losses).tolist()
    print(f"train slice: {FIXED_STEPS} steps on one batch: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({losses[-1] / losses[0]:.3f}x); min {min(losses):.4f}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError("the loss did not fall on a fixed batch")

    host = next(train_it)
    # stop the loader threads (and their prefetch) before anything is
    # timed: they would share the host's cores with the timed calls
    train_it.close()
    test_it.close()
    card_vs_cpu_step(device, spec, cfg, init_net,
                     PL.HostBatch(*(a[:8] for a in host)))

    # ---- 9. times ----------------------------------------------------
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        pp_ms = time_ms(lambda: pp_train(*hb, generator=gen), 10)
        images, labels = pp_train(*hb, generator=gen)
    step_ms = time_ms(lambda: step(state, images, labels), 10)
    fused = TT.make_fused_train_step(spec, cfg, pp_train, torch.bfloat16)
    fused_ms = time_ms(lambda: fused(state, *hb, gen), 10)
    print(f"train b{TRAIN_BATCH} bf16: preprocess {pp_ms:.3f} ms, step "
          f"{step_ms:.3f} ms; preprocess+step {fused_ms:.3f} ms = "
          f"{TRAIN_BATCH * 1e3 / fused_ms:.1f} train imgs/s {tag}")
    workers = PL.DataPipeline(ann, 1, 0, use_native=False).num_workers
    for use_native in (True, False):
        what = "native C++ loader" if use_native else "PIL thread loader"
        if use_native and not native.available():
            print(f"DataPipeline {what}: not built ({native.build_error()})")
            continue
        print(f"DataPipeline {what}: "
              f"{loader_rate(PL, ann, use_native):.1f} imgs/s (8 batches of "
              f"{TRAIN_BATCH}, 512x512 canvases, {workers} threads) {tag}")

    # the rotation at the train batch's shape: events around 20 launches
    # (host launch path included), and the card alone (device_ms: at
    # ~0.03 ms a launch the host's ctypes call is as long as the kernel)
    rng = np.random.default_rng(4)
    for line in ptxas_lines(rot_log, "rotate_kernel") or [
            "not printed: the library was built before this run"]:
        print(f"rotate kernel ptxas: {line}")
    rot = {}
    for dtype in (torch.bfloat16, torch.float32):
        imgs = torch.from_numpy(rng.integers(0, 256, (ROT_N, *spec.in_hw, 3))
                                .astype(np.float32)).to(device).to(dtype)
        tables = TR.shear_tables(torch.from_numpy(np.deg2rad(
            rng.uniform(-10, 10, ROT_N)).astype(np.float32)).to(device),
            *spec.in_hw, dtype)
        plain = lambda: TR._rotate_plain(imgs, tables)  # noqa: E731
        kern = lambda: TR._launch(imgs, tables)  # noqa: E731
        p1, k1, k2, p2 = (time_ms(plain, 5), time_ms(kern, 20),
                          time_ms(kern, 20), time_ms(plain, 5))
        dev_k = device_ms(kern, 20)
        tile = TR.plan_tile(*spec.in_hw, 3, TR.smem_limit(device))
        smem = TR.smem_bytes(tile.rows, tile.staged, 3,
                             TR.frame_geometry(*spec.in_hw)[2])
        r_bound, r_by = bound(2 * imgs.numel() * imgs.element_size(),
                              (imgs.numel() * ROT_OPS, FP32_OPS_PER_S))
        name = str(dtype).split(".")[-1]
        print(f"rotate N={ROT_N} 224x320x3 {name}: kernel {k1:.4f}/{k2:.4f} "
              f"ms a launch by events, {dev_k:.4f} ms with launches queued; "
              f"plain {p1:.4f}/{p2:.4f} ms; bound {r_bound:.4f} ms ({r_by}); "
              f"tile {tile.rows}x{tile.cols} outputs, {tile.staged} staged "
              f"columns, {smem} B of "
              f"shared memory a block, {TR.BLOCKS_PER_SM} blocks an SM "
              f"planned {tag}")
        rot[name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                     "bound_ms": r_bound, "bound_by": r_by,
                     "device_ms": dev_k}

    n_kernels, dev_ms, by_cat, top = kernel_profile(
        lambda: fused(state, *hb, gen), iters=3)
    if n_kernels == 0:
        print(f"profile train step: the profiler recorded no device events; "
              f"device time not measured {tag}")
    else:
        cats = ", ".join(f"{k} {v:.3f} ms" for k, v in by_cat.items())
        print(f"profile train step b{TRAIN_BATCH} bf16: {n_kernels:g} "
              f"kernels/step, device {dev_ms:.3f} ms/step of {fused_ms:.3f} "
              f"ms timed (busy share {dev_ms / fused_ms:.3f}); {cats} {tag}")
        for name, ms, count in top:
            print(f"  {ms:8.3f} ms  x{count:<4g} {name[:100]}")
    print(f"peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB {tag}")
    return ({"launches": rot_launches, "max_abs_err": rot_err,
             **rot["bfloat16"], "library_ms": None}, step_ms, fused_ms)

# ---- bounds: the least time the card could take for a kernel's work -------
# NVIDIA's H100 SXM data sheet, at its 700 W limit (the card's own limit is
# printed beside every time): HBM3 bytes/s, fp32 outside the tensor cores,
# bf16 dense tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12
# operations counted per unit of work (each add, multiply, compare, min,
# max, divide, exp counted once):
DECODE_OPS = 30        # per candidate: 3 sigmoids, 2 exps, letterbox inverse
SCORE_OPS = 4          # per (candidate, class): sigmoid and product
AREA_OPS = 5           # per candidate, once: a box's area
PASS_OPS = 15          # per live candidate and greedy step: intersection,
#                        union, divide, test, argmax
LOAD_OPS = 1           # per (candidate, class) of NMS alone: the first argmax
ROT_OPS = 9            # per element: three 2-tap interpolations
DW_OPS = 22            # per (pixel, channel): 9 taps (18), folded BN, ReLU
PW_EPILOGUE_OPS = 4    # per (pixel, output channel): folded BN, LeakyReLU


def bound(nbytes: float, *ops_at_rate) -> tuple:
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    HBM's rate and of each (operations, peak rate) pair's time."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / rate * 1e3 for ops, rate in ops_at_rate)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def greedy_passes(res) -> int:
    """Greedy steps the kernels ran for an NmsResult: one IoU pass per
    winner kept (a row leaves its loop at its first winner below the
    threshold)."""
    return int(res.valid.sum())


def live_tests(select) -> int:
    """Candidate tests the greedy steps need on these inputs: ``select``
    runs a plain version, whose per-step masks count, at each step of each
    row still in its loop, the candidates not yet suppressed and at or
    above the threshold.  Suppressed and sub-threshold candidates never
    need testing again, so a bound counts only these."""
    live = []
    select(live)
    return sum(live)


def head_bound(bsz, n, classes, max_out, live):
    nbytes = 4 * (bsz * n * (5 + classes) + 8 * n + 8 * bsz
                  + bsz * classes * max_out * 5)
    ops = bsz * n * (DECODE_OPS + AREA_OPS) + bsz * n * classes * SCORE_OPS \
        + live * PASS_OPS
    return bound(nbytes, (ops, FP32_OPS_PER_S))


def nms_bound(bsz, n, classes, max_out, live):
    nbytes = 4 * (bsz * n * 4 + bsz * n * classes + bsz * classes * max_out * 5)
    ops = bsz * n * (classes * LOAD_OPS + AREA_OPS) + live * PASS_OPS
    return bound(nbytes, (ops, FP32_OPS_PER_S))


def dwsep_bound(x, cout):
    """x [B, H, W, C] in its dtype: x read, the output written, the weights
    read once; the depthwise stencil on CUDA cores, the pointwise product at
    the tensor cores' rate for x's dtype (bf16) or fp32's."""
    b, h, w, c = x.shape
    px, elt = b * h * w, x.element_size()
    nbytes = px * (c + cout) * elt + c * cout * elt + 4 * (9 * c + 2 * c
                                                           + 2 * cout)
    mm_rate = BF16_TC_OPS_PER_S if elt == 2 else FP32_OPS_PER_S
    return bound(nbytes, (px * (c * DW_OPS + cout * PW_EPILOGUE_OPS),
                          FP32_OPS_PER_S), (px * 2 * c * cout, mm_rate))


def time_head(name, s, preds, hws_, thresh, max_out, iou, device, tag,
              plain_iters=5, kern_iters=20):
    """The head kernel alone against the plain version of the same function
    on the same prepared inputs (plain, kernel, kernel, plain), on the card
    alone (``device_ms``), and the whole head call both ways; prints them
    with G, blocks an SM and the live candidate tests.  Returns (kernel ms,
    plain ms, bound ms, bound_by, device_ms)."""
    from k210_yolo_framework_tpu_torch.ops import yolo_head_pallas as TH

    p = TH._flatten_preds(preds, s.class_num)
    geom = TH._geometry_on(s, device)
    lbox = TH.letterbox_inverse_params(hws_, s.in_hw).contiguous()
    kw = dict(classes=s.class_num, max_out=max_out, iou_thresh=iou)
    plain = lambda: TH._decode_and_select(  # noqa: E731
        p, geom, lbox, class_softmax=False, stop_below=thresh, **kw)
    kern = lambda: TH._launch(  # noqa: E731
        p, geom, lbox, score_thresh=thresh, class_softmax=False, **kw)
    p1, k1, k2, p2 = (time_ms(plain, plain_iters), time_ms(kern, kern_iters),
                      time_ms(kern, kern_iters), time_ms(plain, plain_iters))
    dev_k = device_ms(kern, kern_iters)
    res = TH.fused_decode_nms(preds, s, hws_, thresh, iou, max_out)
    live = live_tests(lambda lv: TH._decode_and_select(
        p, geom, lbox, class_softmax=False, stop_below=thresh, live=lv,
        **kw))
    bsz, n = p.shape[:2]
    b_ms, by = head_bound(bsz, n, s.class_num, max_out, live)
    # ... and the whole head call, wrapper ops included
    call_k = time_ms(lambda: TH.fused_decode_nms(
        preds, s, hws_, thresh, iou, max_out), kern_iters)
    call_p = time_ms(lambda: TH.fused_decode_nms_reference(
        preds, s, hws_, thresh, iou, max_out), plain_iters)
    layout, rows = TH._plan(device, bsz, n, s.class_num)
    blocks = TH._blocks_per_sm(device, n, rows, layout)
    where = (scratch_line(TH._kernel_lib().yolo_head_scratch_bytes, bsz, n,
                          s.class_num, rows)
             if layout == "global" else "shared memory")
    if layout == "global" and TH._takes_ordered(device, n, max_out, thresh):
        # one launch more, its rows' scan depths read off the tally
        tally = TH.ordered_tally(device)
        before = int(tally.item())
        kern()
        depth = (int(tally.item()) - before) / (bsz * s.class_num)
        scratch = TH._kernel_lib().yolo_head_ordered_scratch_bytes(
            bsz, n, s.class_num)
        where = (f"in score order, scratch {scratch} B, scan depth "
                 f"{depth:.1f} a row")
    print(f"head b{bsz} {name:<6} (N={n}, thresh {thresh}, iou {iou}, "
          f"max_out {max_out}, {layout} layout, G={rows}, {blocks} blocks "
          f"an SM, {where}): kernel "
          f"{k1:.4f}/{k2:.4f} ms a launch by events, {dev_k:.4f} ms with "
          f"launches queued; plain "
          f"{p1:.4f}/{p2:.4f} ms; whole call {call_k:.4f} ms, plain "
          f"call {call_p:.4f} ms; bound {b_ms:.4f} ms "
          f"({by}, {greedy_passes(res)} greedy steps, "
          f"{live} live candidate tests, {per_test(dev_k, live)}) {tag}")
    return (k1 + k2) / 2, (p1 + p2) / 2, b_ms, by, dev_k


def alternating(plain, kern, plain_iters, kern_iters):
    """Times in the order plain, kernel, kernel, plain -> (kernel ms, plain
    ms, the four times)."""
    p1, k1, k2, p2 = (time_ms(plain, plain_iters), time_ms(kern, kern_iters),
                      time_ms(kern, kern_iters), time_ms(plain, plain_iters))
    return (k1 + k2) / 2, (p1 + p2) / 2, (p1, k1, k2, p2)


def per_test(ms: float, live: int) -> str:
    """Kernel time over the live candidate tests, in picoseconds."""
    return f"{1e9 * ms / live:.3f} ps a test" if live else "no test"


def n_differing(got, want) -> int:
    """Elements of two NmsResults that differ (NaN equal to NaN)."""
    import torch

    return sum(int((~((g == w) | (torch.isnan(g) & torch.isnan(w)))).sum())
               if g.is_floating_point() else int((g != w).sum())
               for g, w in zip(got, want))


NMS_MAX_OUTS = ((30, None), (100, 0.01))   # (max_out, threshold or flavour's)


def nms_kernel_phase(spec, spec3, device) -> float:
    """Phase 10: NMS alone, kernel against its plain version bit for bit, on
    phase 3's cases decoded by the port's ``decode_outputs``, in both score
    flavours, at max_out 30 and at the eval settings (max_out 100,
    threshold 0.01).  Returns the largest absolute difference of scores and
    boxes (0 when bit-identical)."""
    import torch

    from k210_yolo_framework_tpu_torch.ops import decode as TD
    from k210_yolo_framework_tpu_torch.ops import nms_pallas as TN

    max_err = 0.0
    for name, s, preds, hws in head_cases(spec, spec3, device):
        for softmax, flavour_thresh in FLAVOURS:
            boxes, scores = TD.decode_outputs(preds, s, hws, softmax)
            for max_out, thresh in NMS_MAX_OUTS:
                thresh = flavour_thresh if thresh is None else thresh
                got = TN.batched_nms_pallas(boxes, scores, thresh, IOU,
                                            max_out)
                torch.cuda.synchronize()
                want = TN.batched_nms_pallas_reference(boxes, scores, thresh,
                                                       IOU, max_out)
                diff = n_differing(got, want)
                max_err = max(max_err, *(
                    float(torch.nan_to_num(g - w).abs().max())
                    for g, w in zip(got[:2], want[:2])))
                print(f"nms kernel vs plain: {name:<11} softmax="
                      f"{softmax!s:<5} N={boxes.shape[1]} max_out={max_out} "
                      f"thresh={thresh} kept={int(got.valid.sum())} "
                      f"elements_differing={diff}")
                if diff:
                    raise AssertionError("the NMS kernel differs from its "
                                         "plain version")
                if name == "empty" and bool(got.valid.any()):
                    raise AssertionError("detections from an empty scene")
    return max_err


def two_stage_phase(spec, scenes, scene_preds, h_dev):
    """Phase 11: the two-stage head, ``decode_outputs`` ->
    ``batched_nms_pallas`` (the kernel), on each serving scene's own bf16
    logits at B=128, against the fused head kernel on the same logits (the
    JAX package's own check) and against the export program's
    ``ops/nms.batched_nms`` at top_k = N.  Returns the NMS kernel's
    launches in the path."""
    import torch

    from k210_yolo_framework_tpu_torch.ops import decode as TD
    from k210_yolo_framework_tpu_torch.ops import nms as TNX
    from k210_yolo_framework_tpu_torch.ops import nms_pallas as TN
    from k210_yolo_framework_tpu_torch.ops import yolo_head_pallas as TH
    from k210_yolo_framework_tpu_torch.utils.detmatch import (
        assert_detections_close,
    )

    TN.batched_nms_pallas.launches = 0
    two = {}
    for name, p in scenes:
        boxes, scores = TD.decode_outputs(scene_preds[name], spec, h_dev)
        two[name] = (boxes, scores, TN.batched_nms_pallas(
            boxes, scores, p.obj_thresh, IOU, 30))
    torch.cuda.synchronize()
    launches = TN.batched_nms_pallas.launches
    print(f"two-stage: NMS kernel launches {launches} in {len(scenes)} "
          f"two-stage calls")
    if launches != len(scenes):
        raise AssertionError("the NMS kernel did not run once per two-stage "
                             "call")
    for name, p in scenes:
        boxes, scores, res = two[name]
        fused = TH.fused_decode_nms(scene_preds[name], spec, h_dev,
                                    p.obj_thresh, IOU, 30)
        err, flip = compare_heads(res, fused, p.obj_thresh)
        n_a, n_b = assert_detections_close(to_np(res), to_np(fused))
        n = boxes.shape[1]
        parts = [TNX.batched_nms(boxes[i:i + 8], scores[i:i + 8],
                                 p.obj_thresh, IOU, 30, top_k=n)
                 for i in range(0, boxes.shape[0], 8)]
        xla = TNX.NmsResult(*(torch.cat(t) for t in zip(*parts)))
        n_x, _ = assert_detections_close(to_np(xla), to_np(res))
        print(f"two-stage {name:<6} (obj_thresh {p.obj_thresh}): kernel "
              f"{n_a}, fused head {n_b}, max_abs_err={err:.3g} "
              f"borderline_flips={flip}; export NMS (top_k={n}) {n_x}, "
              f"elements differing from the kernel {n_differing(xla, res)}")
    return launches


DW_BLOCKS = (1, 3, 5, 7, 8, 9, 10, 11, 13)     # the stride-1 blocks
DW_TOL = {"bf16": 0.05, "fp32": 2e-5}          # tests/test_dwsep_pallas.py


def capture_blocks(net, forward):
    """Each stride-1 block's input and output during ``forward()``."""
    seen = {}
    hooks = [getattr(net.backbone, f"block_{i}").register_forward_hook(
        lambda mod, args, out, i=i: seen.__setitem__(i, (args[0], out)))
        for i in DW_BLOCKS]
    try:
        forward()
    finally:
        for h in hooks:
            h.remove()
    return seen


def dwsep_phase(pred, fp32_pred, c_dev, h_dev, part, tag):
    """Phase 12: the fused block on the nine stride-1 blocks of the served
    net.  Each block's input comes from the serving forward at B=128 in
    bf16 (the previous block's epilogue stores bf16; the kernel takes its
    NHWC view), its BN folded by ``block_params``.  Kernel against
    ``fused_dwsep_reference`` and against the block's own output (bf16
    0.05: folding rounds the BN differently); then the same at B=8 in fp32
    (2e-5 against the plain version).  Returns the kernel's JSON fields and
    the per-block inputs for the times."""
    import torch

    from k210_yolo_framework_tpu_torch.ops import dwsep_pallas as TF

    seen = capture_blocks(pred.net, lambda: pred._forward_batch(c_dev, h_dev))
    inputs = {}
    for i in DW_BLOCKS:
        # the served net is channels_last: its NCHW activations lie in
        # memory as NHWC, so the cast keeps that layout and the permute is
        # a view, not a copy
        x = seen[i][0].to(torch.bfloat16).permute(0, 2, 3, 1)
        inputs[i] = (x, TF.block_params(getattr(pred.net.backbone,
                                                f"block_{i}")))
    TF.fused_dwsep.launches = 0
    outs = {i: TF.fused_dwsep(x, *params) for i, (x, params) in inputs.items()}
    torch.cuda.synchronize()
    launches = TF.fused_dwsep.launches
    print(f"dwsep: kernel launches {launches} on the {len(DW_BLOCKS)} "
          f"stride-1 blocks of the served net (B={BATCH}, bf16)")
    if launches != len(DW_BLOCKS):
        raise AssertionError("the dwsep kernel did not run once per block")
    max_err = 0.0
    for i, (x, params) in inputs.items():
        got = outs[i].float()
        want = TF.fused_dwsep_reference(x, *params).float()
        block_out = seen[i][1].permute(0, 2, 3, 1).float()
        err = float((got - want).abs().max())
        err_block = float((got - block_out).abs().max())
        bad = int((~torch.isclose(got, want, rtol=DW_TOL["bf16"],
                                  atol=DW_TOL["bf16"])).sum())
        bad_block = int((~torch.isclose(got, block_out, rtol=DW_TOL["bf16"],
                                        atol=DW_TOL["bf16"])).sum())
        b, h, w, c = x.shape
        view = "free (channels_last)" if x.is_contiguous() else "a copy"
        print(f"dwsep block_{i:<2} {h}x{w}x{c}->{got.shape[-1]} bf16: "
              f"NHWC view {view}; vs plain max_abs_err={err:.3g} outside={bad}; vs the "
              f"block's own output max_abs_err={err_block:.3g} "
              f"outside={bad_block}")
        if bad or bad_block or not torch.isfinite(got).all():
            raise AssertionError(f"dwsep block_{i} disagrees")
        max_err = max(max_err, err)

    seen32 = capture_blocks(fp32_pred.net, lambda: fp32_pred._forward_batch(
        c_dev[part], h_dev[part]))
    for i in DW_BLOCKS:
        x = seen32[i][0].permute(0, 2, 3, 1)
        params = TF.block_params(getattr(fp32_pred.net.backbone,
                                         f"block_{i}"))
        got = TF.fused_dwsep(x, *params).float()
        want = TF.fused_dwsep_reference(x, *params)
        block_out = seen32[i][1].permute(0, 2, 3, 1)
        bad = int((~torch.isclose(got, want, rtol=DW_TOL["fp32"],
                                  atol=DW_TOL["fp32"])).sum())
        print(f"dwsep block_{i:<2} fp32 B={x.shape[0]}: vs plain "
              f"max_abs_err={float((got - want).abs().max()):.3g} "
              f"outside={bad}; vs the block's own output "
              f"{float((got - block_out).abs().max()):.3g}")
        if bad:
            raise AssertionError(f"dwsep block_{i} fp32 disagrees")

    # a NaN in the input gives NaN at the same outputs in both versions
    for i in (DW_BLOCKS[0], DW_BLOCKS[-1]):
        x, params = inputs[i]
        x = x.clone()
        x[0, 1, 2, 0] = float("nan")
        x[-1, -1, -1, -1] = float("nan")
        got = torch.isnan(TF.fused_dwsep(x, *params))
        want = torch.isnan(TF.fused_dwsep_reference(x, *params))
        same = torch.equal(got, want)
        print(f"dwsep block_{i:<2} NaN in x: {int(got.sum())} NaN outputs, "
              f"{int(want.sum())} in the plain version, same positions: "
              f"{same}")
        if not same or not got.any():
            raise AssertionError(f"dwsep block_{i}: NaN positions differ")
    return {"launches": launches, "max_abs_err": max_err}, inputs


def record_as_result(record, n_images: int):
    """A DetectionRecord's detections per image, stacked into the padded
    layout ``utils/detmatch`` reads."""
    from k210_yolo_framework_tpu_torch.inference import (
        Detections,
        stack_detections,
    )

    per = [[] for _ in range(n_images)]
    for c, dets in enumerate(record.dets):
        for img, score, box in dets:
            per[img].append((box, score, c))
    return stack_detections([Detections(
        np.reshape([d[0] for d in p], (-1, 4)), np.array([d[1] for d in p]),
        np.array([d[2] for d in p], int)) for p in per])


# keras_eval.py's defaults: a low threshold, more boxes per class
EVAL = dict(obj_thresh=0.01, iou_thresh=0.45, max_out=100)
EVAL_BATCH = 32


def eval_phase(net, spec, ann, device, tag):
    """Phase 13: VOC evaluation (``eval.collect_detections`` and
    ``match_detections``) of a bf16 Predictor over the synthetic JPEGs at
    the eval settings, batch 32 on 512x512 canvases staged on host threads:
    one head launch per batch, a finite mAP, well-formed detections; then
    8 images in fp32, card against CPU.  Returns eval imgs/s, host staging
    included."""
    import torch

    from k210_yolo_framework_tpu_torch.eval import (
        collect_detections,
        match_detections,
    )
    from k210_yolo_framework_tpu_torch.inference import Predictor
    from k210_yolo_framework_tpu_torch.ops import yolo_head_pallas as TH
    from k210_yolo_framework_tpu_torch.utils.detmatch import (
        assert_detections_close,
    )

    pred = Predictor(net, None, spec, compute_dtype=torch.bfloat16,
                     device=device, **EVAL)
    n_batches = -(-len(ann) // EVAL_BATCH)
    TH.fused_decode_nms.launches = 0
    record = collect_detections(pred, ann, spec.class_num, EVAL_BATCH)
    torch.cuda.synchronize()
    launches = TH.fused_decode_nms.launches
    res = match_detections(record)
    n_dets = sum(len(d) for d in record.dets)
    print(f"eval: {len(ann)} images in {n_batches} batches of {EVAL_BATCH}: "
          f"head kernel launches {launches}; {n_dets} detections; mAP@0.5 "
          f"{res['map']:.4f} (seeded random weights: plumbing only)")
    if launches != n_batches:
        raise AssertionError("the head kernel did not run once per eval "
                             "batch")
    if not np.isfinite(res["map"]):
        raise AssertionError("eval mAP is not finite")
    per_image = np.zeros(len(ann), int)
    for c, dets in enumerate(record.dets):
        for img, score, box in dets:
            per_image[img] += 1
            if not (np.isfinite(score) and score >= EVAL["obj_thresh"]
                    and np.asarray(box).shape == (4,)
                    and not np.isnan(box).any()):
                raise AssertionError(f"eval: malformed detection {c} "
                                     f"{score} {box}")
    if per_image.max() > spec.class_num * EVAL["max_out"] or n_dets == 0:
        raise AssertionError("eval: detection counts out of range")

    t0 = time.perf_counter()
    collect_detections(pred, ann, spec.class_num, EVAL_BATCH)
    dt = time.perf_counter() - t0
    print(f"eval b{EVAL_BATCH} bf16 (obj_thresh {EVAL['obj_thresh']}, "
          f"max_out {EVAL['max_out']}): {len(ann)} images in {dt:.3f} s = "
          f"{len(ann) / dt:.1f} imgs/s, JPEG decode and staging included "
          f"{tag}")

    small = ann[:8]
    recs = [collect_detections(Predictor(net, None, spec, device=d, **EVAL),
                               small, spec.class_num, 8)
            for d in (device, "cpu")]
    n_a, n_b = assert_detections_close(*(record_as_result(r, len(small))
                                         for r in recs))
    print(f"eval fp32 card vs CPU ({len(small)} images): {n_a} vs {n_b} "
          f"detections match")
    return len(ann) / dt


def cudnn_pair(x, dw_k, dw_mul, dw_add, pw_k, pw_mul, pw_add):
    """The block as an unfused bf16 cuDNN pair, each BN folded into its
    conv's weights and bias: a function of no arguments taking x [B, H, W,
    C] bf16 (the NHWC view of a channels_last tensor) to [B, H, W, Cout]
    bf16.  It reads and writes what the fused kernel does, plus the bf16
    intermediate and the two activations' in-place passes."""
    import torch
    import torch.nn.functional as F

    bf = torch.bfloat16
    xc = x.permute(0, 3, 1, 2)                       # channels_last NCHW view
    w_dw = (dw_k * dw_mul).permute(2, 0, 1)[:, None].to(bf)      # [C, 1, 3, 3]
    w_pw = (pw_k.float() * pw_mul).t()[:, :, None, None].to(bf)  # [Cout, C]
    w_dw, w_pw = (w.contiguous(memory_format=torch.channels_last)
                  for w in (w_dw, w_pw))
    b_dw, b_pw = dw_add.to(bf), pw_add.to(bf)

    def run():
        t = torch.relu_(F.conv2d(xc, w_dw, b_dw, padding=1,
                                 groups=xc.shape[1]))
        return F.leaky_relu(F.conv2d(t, w_pw, b_pw), 0.3,
                            inplace=True).permute(0, 2, 3, 1)
    return run


def new_kernel_times(scenes, scene_preds, spec, h_dev, dw_inputs, pred, tag):
    """Phase 14: NMS alone and the fused block, each against its plain
    version on the same inputs (plain, kernel, kernel, plain); for the
    block also the served net's own block on the same input (two cuDNN
    convs, each with its conv epilogue; bf16 output) and the bytes-equal
    baseline, an
    unfused bf16 cuDNN pair with BN folded.  Returns the two kernels' JSON
    fields (time, plain time, bound)."""
    import torch

    from k210_yolo_framework_tpu_torch.ops import decode as TD
    from k210_yolo_framework_tpu_torch.ops import dwsep_pallas as TF
    from k210_yolo_framework_tpu_torch.ops import nms_pallas as TN

    nms = {}
    for name, p in scenes:
        boxes, scores = TD.decode_outputs(scene_preds[name], spec, h_dev)
        kw = dict(max_out=30, iou_thresh=IOU)
        plain = lambda: TN._select(  # noqa: E731
            boxes, scores, stop_below=p.obj_thresh, **kw)
        kern = lambda: TN._launch(  # noqa: E731
            boxes, scores, score_thresh=p.obj_thresh, **kw)
        k_ms, p_ms, (p1, k1, k2, p2) = alternating(plain, kern, 5, 20)
        dev_k = device_ms(kern, 20)
        res = TN.batched_nms_pallas(boxes, scores, p.obj_thresh, IOU, 30)
        live = live_tests(lambda lv: TN._select(
            boxes, scores, stop_below=p.obj_thresh, live=lv, **kw))
        b_ms, by = nms_bound(*scores.shape[:2], spec.class_num, 30, live)
        nms[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
                         device_ms=dev_k)
        layout, rows = TN._plan(boxes.device, *scores.shape)
        print(f"nms b{BATCH} {name:<6} (N={boxes.shape[1]}, obj_thresh "
              f"{p.obj_thresh}, {layout} layout, G={rows}, "
              f"{greedy_passes(res)} greedy steps, "
              f"{live} live candidate tests, {per_test(dev_k, live)}): kernel "
              f"{k1:.4f}/{k2:.4f} ms a launch by events, {dev_k:.4f} ms with "
              f"launches queued; plain {p1:.4f}/{p2:.4f} ms, bound "
              f"{b_ms:.4f} ms ({by}) {tag}")

    dw = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, block_ms=0.0, pair_ms=0.0)
    ops_bound = 0
    with torch.inference_mode():
        for i, (x, params) in dw_inputs.items():
            block = getattr(pred.net.backbone, f"block_{i}")
            x_nchw = x.permute(0, 3, 1, 2)      # the block's own layout
            pw_k = params[3].to(x.dtype)
            k_ms, p_ms, (p1, k1, k2, p2) = alternating(
                lambda: TF.fused_dwsep_reference(x, *params),
                lambda: TF._launch(x, *params[:3], pw_k, *params[4:], 0.3),
                3, 10)
            blk_ms = time_ms(lambda: block(x_nchw, torch.bfloat16), 10)
            pair = cudnn_pair(x, *params)
            pair_ms = time_ms(pair, 10)
            pair_err = float((pair().float() - TF.fused_dwsep_reference(
                x, *params).float()).abs().max())
            b_ms, by = dwsep_bound(x, params[3].shape[1])
            ops_bound += by == "operations"
            for k, v in (("ms", k_ms), ("plain_ms", p_ms), ("bound_ms", b_ms),
                         ("block_ms", blk_ms), ("pair_ms", pair_ms)):
                dw[k] += v
            b, h, w, c = x.shape
            print(f"dwsep b{b} block_{i:<2} {h}x{w}x{c}->{params[3].shape[1]}"
                  f" bf16: kernel {k1:.4f}/{k2:.4f} ms, plain "
                  f"{p1:.4f}/{p2:.4f} ms, served block (epilogues, bf16 out) "
                  f"{blk_ms:.4f} ms, bf16 cuDNN pair {pair_ms:.4f} ms "
                  f"(max_abs_err vs plain {pair_err:.3g}), bound "
                  f"{b_ms:.4f} ms ({by}) {tag}")
    dw["bound_by"] = "operations" if 2 * ops_bound > len(dw_inputs) \
        else "bytes"
    print(f"dwsep b{BATCH} nine blocks: kernel {dw['ms']:.4f} ms, plain "
          f"{dw['plain_ms']:.4f} ms, served blocks (epilogues, bf16 out) "
          f"{dw['block_ms']:.4f} ms, bf16 cuDNN pairs {dw['pair_ms']:.4f} ms, "
          f"bound {dw['bound_ms']:.4f} ms ({ops_bound} of "
          f"{len(dw_inputs)} blocks bound by operations) {tag}")
    return nms, dw


# ---- 15. the builders ------------------------------------------------------
# (name, alpha, layers): yolo_mobilev2 at the Makefile's DEPTHMUL (the K210
# caps on, head width 128), tiny_yolo, and the darknet53 yolo on three
# scales (4,410 candidates at 224x320)
BUILDERS = (("yolo_mobilev2", 0.75, 2), ("tiny_yolo", 1.0, 2),
            ("yolo", 1.0, 3))
BUILDER_TRAIN_BATCHES = (TRAIN_BATCH, 64, 32)   # tried in turn on OOM
SMALL_HW = (96, 128)                            # card against CPU
# The seeded builders at B=2 are far worse conditioned than phase 8's net:
# on the CPU alone, one-ulp input noise moves some of yolo_mobilev2's and
# yolo's gradients by up to 29% and 40% of their largest entry (64x96), and
# the 64-ulp noise below some of all three builders' by 45-87% (96x128),
# past GRAD_CAP.  Their as-trained gradients are held to
# GRAD_TOL + ENVELOPE x that spread, capped only at the entry's own size;
# the smooth witness holds every gradient to GRAD_TOL.  The card's
# forward differs from the CPU's by up to 8e-6 of a layer's largest value
# (H100, fp32: cuDNN against the CPU's convs), 64 ulps, and a tiny_yolo
# pool window whose two largest values lie that close sends its gradient
# elsewhere; so the spread is taken under perturbations of that size.
BUILDER_GRAD_CAP = 1.0
BUILDER_NOISE = 2.0 ** -17


def builder_spec(layers, in_hw=(224, 320)):
    """The VOC spec at ``in_hw``; with three layers, the anchors of
    ``three_scale_spec`` on grids at strides 32, 16 and 8."""
    from k210_yolo_framework_tpu_torch import YoloSpec, voc_spec

    strides = (32, 16, 8)[:layers]
    out_hws = tuple((in_hw[0] // st, in_hw[1] // st) for st in strides)
    if layers == 2:
        return voc_spec(in_hw, out_hws)
    return YoloSpec.create(in_hw, out_hws, 20, three_scale_spec().anchors)


def dense_state(net, spec):
    """``net``'s state with +3 on every output conv's conf and class
    biases: most rows then run all 30 greedy steps."""
    state = {k: v.clone() for k, v in net.state_dict().items()}
    e = 5 + spec.class_num
    for k, bias in state.items():
        if k.endswith("dark_conv_out.bias"):
            for a in range(spec.nanchors):
                bias[a * e + 4:(a + 1) * e] += 3.0
    return state


def builder_serve(name, net, spec, device, canvases, hws, image, tag):
    """Serve ``net`` in bf16 at B=128 through ``predict_batch`` and
    ``predict_image`` in the 0.7 and the dense-bias scenes; one head launch
    per call, detections against the plain head on the same Predictor's
    logits; serve rate, batch-1 latency and a kernel profile.  Returns the
    scenes' B=128 logits and the canvases' sizes on the card."""
    import torch

    from k210_yolo_framework_tpu_torch.inference import (
        Predictor,
        stack_detections,
    )
    from k210_yolo_framework_tpu_torch.ops import letterbox as LB
    from k210_yolo_framework_tpu_torch.ops import yolo_head_pallas as TH
    from k210_yolo_framework_tpu_torch.utils.detmatch import (
        assert_detections_close,
    )

    serve = dict(iou_thresh=IOU, compute_dtype=torch.bfloat16, device=device)
    scenes = (("sparse", Predictor(net, None, spec, obj_thresh=0.7, **serve)),
              ("dense", Predictor(net, dense_state(net, spec), spec,
                                  obj_thresh=0.7, **serve)))
    n = sum(h * w for h, w in spec.out_hws) * spec.nanchors
    TH.fused_decode_nms.launches = 0
    served = {k: (p.predict_batch(canvases, hws), p.predict_image(image))
              for k, p in scenes}
    torch.cuda.synchronize()
    launches = TH.fused_decode_nms.launches
    print(f"{name}: serving, N={n}: head kernel launches {launches} in "
          f"{2 * len(scenes)} calls")
    if launches != 2 * len(scenes):
        raise AssertionError(f"{name}: the head kernel did not run once per "
                             "serving call")
    c_dev = torch.from_numpy(canvases).to(device)
    h_dev = torch.from_numpy(hws).to(device)
    img_t = torch.from_numpy(image).to(device)
    hw1 = torch.tensor([image.shape[:2]], dtype=torch.int32, device=device)
    logits = {}
    for scene, p in scenes:
        dets, one = served[scene]
        with torch.inference_mode():
            lb = LB.letterbox_image(img_t[None], hw1, spec.in_hw,
                                    torch.float32).to(torch.uint8)
            inputs = ((p._forward_batch(c_dev, h_dev), h_dev, dets),
                      (p._forward(lb), hw1, [one]))
        for what, (preds, hws_, dets_) in zip(("batch", "image"), inputs):
            if [tuple(t.shape[1:3]) for t in preds] != list(spec.out_hws):
                raise AssertionError(f"{name}: head output shapes")
            want = TH.fused_decode_nms_reference(preds, spec, hws_,
                                                 p.obj_thresh, IOU, 30)
            err, flip = compare_heads(p._head(preds, hws_), want,
                                      p.obj_thresh)
            n_a, n_b = assert_detections_close(stack_detections(dets_),
                                               to_np(want))
            print(f"{name}: {scene:<6} {what}: served {n_a} detections, "
                  f"plain head {n_b}; same forward max_abs_err={err:.3g} "
                  f"borderline_flips={flip}")
            if scene == "dense" and n_a == 0:
                raise AssertionError(f"{name}: the dense scene has no "
                                     "detections")
        logits[scene] = inputs[0][0]

    pred = scenes[0][1]
    serve_ms = time_ms(lambda: pred._run_batch(c_dev, h_dev), 10)
    b1_ms = time_ms(lambda: pred._run_batch(c_dev[:1], h_dev[:1]), 20)
    n_kernels, dev_ms, by_cat, top = kernel_profile(
        lambda: pred._run_batch(c_dev, h_dev), iters=2)
    elementwise = by_cat["elementwise/other"]
    print(f"{name}: serve b{BATCH} bf16 {serve_ms:.3f} ms/batch = "
          f"{BATCH * 1e3 / serve_ms:.1f} imgs/s; b1 latency {b1_ms:.3f} ms; "
          f"profile b{BATCH}: {n_kernels:g} kernels/call, device "
          f"{dev_ms:.3f} ms/call (busy share {dev_ms / serve_ms:.3f}), "
          f"elementwise/other {elementwise:.3f} ms "
          f"({elementwise / max(dev_ms, 1e-9):.1%}), conv/matmul "
          f"{by_cat['conv/matmul']:.3f} ms, epilogue kernel "
          f"{by_cat['epilogue kernel']:.3f} ms, head kernel "
          f"{by_cat['head kernel']:.3f} ms {tag}")
    return logits, h_dev


def builder_train(name, alpha, spec, device, ann, tag):
    """``fit`` for 3 steps with augment on in bf16 at the largest batch of
    BUILDER_TRAIN_BATCHES that fits: one rotation launch a step, finite
    scalars, parameters and BN statistics moved; for yolo_mobilev2 one
    more step moves a running mean by exactly m r + (1 - m) batch with
    m = 0.999; then the train rate and the peak device memory."""
    import gc

    import torch

    from k210_yolo_framework_tpu_torch.config import TrainConfig
    from k210_yolo_framework_tpu_torch.data import pipeline as PL
    from k210_yolo_framework_tpu_torch.models import build_network
    from k210_yolo_framework_tpu_torch.ops import rotate_pallas as TR
    from k210_yolo_framework_tpu_torch.training import train as TT

    pp = PL.make_preprocess_fn(spec, True, torch.bfloat16)
    for b in BUILDER_TRAIN_BATCHES:
        cfg = TrainConfig(batch_size=b, max_epochs=1, augment=True)
        net = build_network(name, spec.in_hw, spec.nanchors, spec.class_num,
                            alpha=alpha,
                            generator=torch.Generator().manual_seed(0))
        before = {k: v.clone() for k, v in net.state_dict().items()}
        it = iter(PL.DataPipeline(ann, b, seed=0))
        scalars = []
        torch.cuda.reset_peak_memory_stats()
        TR.rotate_3shear.launches = 0
        try:
            state = TT.fit(net, spec, cfg, it, None, pp, None, 3, 0,
                           device=device,
                           generator=torch.Generator().manual_seed(6),
                           compute_dtype=torch.bfloat16,
                           log_fn=lambda line: print(f"  {name} fit: {line}"),
                           scalar_logger=lambda s, d: scalars.append((s, d)))
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError:
            it.close()
            del net
            gc.collect()
            torch.cuda.empty_cache()
            print(f"{name}: train batch {b} does not fit the card's memory")
    else:
        raise AssertionError(f"{name}: no train batch fits")
    launches = TR.rotate_3shear.launches
    print(f"{name}: train b{b} bf16: rotate kernel launches {launches} in 3 "
          f"steps")
    if launches != 3:
        raise AssertionError(f"{name}: the rotation did not run once a step")
    if [s for s, _ in scalars] != [1, 2, 3] or not all(
            np.isfinite(v) for _, d in scalars for v in d.values()):
        raise AssertionError(f"{name}: logged scalars {scalars}")
    after = net.state_dict()
    # yolo_mobilev2's project BN biases have a gradient of 0 but for
    # rounding (a 1x1 conv and a train-mode BN follow them): Adam may
    # leave them as they were
    still = [k for k in before if torch.equal(after[k].cpu(), before[k])]
    print(f"{name}: {len(before) - len(still)} of {len(before)} parameters "
          f"and BN statistics moved; unmoved: {still[:4]}"
          f"{' ...' if len(still) > 4 else ''}")
    if any(not k.endswith("project.bn.bias") for k in still):
        raise AssertionError(f"{name}: parameters or statistics did not move")

    hb = next(it).to(device)
    it.close()
    gen = torch.Generator().manual_seed(3)
    if name == "yolo_mobilev2":
        bn = state.net.backbone.block_5.project.bn
        seen = {}
        hook = bn.register_forward_pre_hook(
            lambda mod, args: seen.setdefault("x", args[0].detach().clone()))
        old = bn.running_mean.clone()
        with torch.no_grad():
            images, labels = pp(*hb, generator=gen)
        TT.make_train_step(spec, cfg, torch.bfloat16)(state, images, labels)
        hook.remove()
        batch = seen["x"].to(torch.float32).mean(dim=(0, 2, 3))
        new = bn.running_mean
        exact = torch.equal(new, 0.999 * old + (1 - 0.999) * batch)
        step_err = float(((new - old) - 0.001 * (batch - old)).abs().max())
        print(f"{name}: BN momentum {bn.momentum}: one step moved "
              f"block_5.project's running mean to 0.999 r + 0.001 batch "
              f"{'exactly' if exact else 'NOT exactly'}; |(new - r) - "
              f"0.001 (batch - r)| <= {step_err:.3g}")
        if not exact or bn.momentum != 0.999:
            raise AssertionError(f"{name}: BN momentum is not 0.999")
    fused = TT.make_fused_train_step(spec, cfg, pp, torch.bfloat16)
    step_ms = time_ms(lambda: fused(state, *hb, gen), 5, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{name}: train b{b} bf16 preprocess+step {step_ms:.3f} ms = "
          f"{b * 1e3 / step_ms:.1f} train imgs/s; peak device memory "
          f"{peak:.2f} GiB {tag}")
    del state, net
    gc.collect()
    torch.cuda.empty_cache()


def candidate_limits(device, tag):
    """The most candidates a block's shared memory holds on this card, and
    for each builder the layout its rows take (shared / own / global) at
    B=128 at three input sizes, and the first square in_hw (multiples of
    32) on the global path.  No size is refused."""
    from k210_yolo_framework_tpu_torch.ops import yolo_head_pallas as TH
    from k210_yolo_framework_tpu_torch.ops.nms_pallas import own_capacity

    limit = own_capacity(TH._kernel_lib().yolo_head_smem_bytes,
                         TH._smem_limit(device))
    print(f"head kernel: at most {limit} candidates in a block's shared "
          f"memory on this card, more on the global path {tag}")
    for name, _, layers in BUILDERS:
        per_px = 3 * sum(4 ** i for i in range(layers)) / 1024
        side = next(k for k in range(32, 4096, 32)
                    if per_px * k * k > limit)
        shapes = ", ".join(
            f"{h}x{w}: N={int(per_px * h * w)} "
            f"{TH._plan(device, BATCH, int(per_px * h * w), 20)[0]}"
            for h, w in ((224, 320), (416, 416), (608, 608)))
        print(f"{name}: {shapes}; the first square in_hw on the global "
              f"path is {side}x{side}")


def builders_phase(device, tag, ann, canvases, hws, image):
    """Phase 15: each builder served, trained, and held card against CPU;
    then the head kernel at 4,410 candidates on the served yolo's own
    logits.  Prints each part's wall seconds."""
    import copy

    import torch

    from k210_yolo_framework_tpu_torch.config import TrainConfig
    from k210_yolo_framework_tpu_torch.data import pipeline as PL
    from k210_yolo_framework_tpu_torch.models import build_network

    yolo_logits = None
    for name, alpha, layers in BUILDERS:
        spec = builder_spec(layers)
        t0 = time.perf_counter()
        net = build_network(name, spec.in_hw, spec.nanchors, spec.class_num,
                            alpha=alpha,
                            generator=torch.Generator().manual_seed(0))
        logits, h_dev = builder_serve(name, net, spec, device, canvases, hws,
                                      image, tag)
        if name == "yolo":
            yolo_logits = (spec, logits, h_dev)
        t1 = time.perf_counter()
        builder_train(name, alpha, spec, device, ann, tag)
        t2 = time.perf_counter()
        small = builder_spec(layers, SMALL_HW)
        it = iter(PL.DataPipeline(ann, 2, seed=4))
        host = next(it)
        it.close()
        init_net = build_network(name, small.in_hw, small.nanchors,
                                 small.class_num, alpha=alpha,
                                 generator=torch.Generator().manual_seed(1))
        print(f"{name}: card against CPU, fp32, B=2 at "
              f"{SMALL_HW[0]}x{SMALL_HW[1]}:")
        card_vs_cpu_step(device, small, TrainConfig(batch_size=2),
                         copy.deepcopy(init_net), host, BUILDER_GRAD_CAP,
                         vanishing=("project.bn.bias",), noise=BUILDER_NOISE)
        t3 = time.perf_counter()
        print(f"{name}: wall seconds: serve {t1 - t0:.1f}, train "
              f"{t2 - t1:.1f}, card against CPU {t3 - t2:.1f}")

    t0 = time.perf_counter()
    spec, logits, h_dev = yolo_logits
    for scene in ("sparse", "dense"):
        time_head(f"yolo {scene}", spec, logits[scene], h_dev, 0.7, 30, IOU,
                  device, tag, kern_iters=10)
    time_head("yolo eval", spec, [t[:EVAL_BATCH] for t in logits["sparse"]],
              h_dev[:EVAL_BATCH], EVAL["obj_thresh"], EVAL["max_out"],
              EVAL["iou_thresh"], device, tag, plain_iters=2, kern_iters=10)
    candidate_limits(device, tag)
    print(f"head at 4,410 candidates: wall seconds "
          f"{time.perf_counter() - t0:.1f}")



# ---- 16. the entry points ----------------------------------------------------
# the command-line scripts on phase 8's JPEGs, laid out as they expect
# (data/<set>_img_ann.npy, data/<set>_anchor.npy) in a working directory
CLI_SET = "smoke"
CLI_NET = ["--train_set", CLI_SET, "--class_num", "20", "--model_def",
           "yolo_mobilev1", "--depth_multiplier", "0.75", "--device", "cuda"]
# batch 64 at split 0.25 of 256: 3 train steps and 1 validation step an
# epoch; the masks' last update falls on the schedule's end (step 3)
CLI_TRAIN = CLI_NET + ["--batch_size", "64", "--vaildation_split", "0.25",
                       "--is_prune", "True", "--prune_frequency", "1",
                       "--prune_end_epoch", "1"]
PRUNE_FINAL = 0.9          # keras_train's --prune_final_sparsity default
ROT_TRACE_NAME = "rotate_kernel"   # csrc/rotate3shear.cu's __global__
CLI_ECHO = 14              # captured lines echoed per script


def captured(fn):
    """(fn's result, its standard output); the first CLI_ECHO lines are
    echoed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn()
    text = buf.getvalue()
    lines = text.splitlines()
    for line in lines[:CLI_ECHO]:
        print(f"  | {line}")
    if len(lines) > CLI_ECHO:
        print(f"  | ... {len(lines) - CLI_ECHO} more lines")
    return res, text


def table_lines(det) -> list:
    """keras_inference's rows for ``det``."""
    return [f"[{t:.1f}\t{l:.1f}\t{b:.1f}\t{r:.1f}\t{s:.2f}\t{int(c):2d}]"
            for (t, l, b, r), s, c in zip(det.boxes, det.scores,
                                          det.classes)]


def prune_step_times(device, tag, ann):
    """The B=128 bf16 train step on one preprocessed batch: pruning off,
    a step that updates the masks, a step that only applies them; then
    ``update_masks`` and ``apply_masks`` alone."""
    import dataclasses

    import torch

    from k210_yolo_framework_tpu_torch import voc_spec
    from k210_yolo_framework_tpu_torch.config import TrainConfig
    from k210_yolo_framework_tpu_torch.data import pipeline as PL
    from k210_yolo_framework_tpu_torch.models import build_network
    from k210_yolo_framework_tpu_torch.training import pruning as P
    from k210_yolo_framework_tpu_torch.training import train as TT

    spec = voc_spec()
    it = iter(PL.DataPipeline(ann, TRAIN_BATCH, seed=5))
    hb = next(it).to(device)
    it.close()
    with torch.no_grad():
        images, labels = PL.make_preprocess_fn(spec, True, torch.bfloat16)(
            *hb, generator=torch.Generator().manual_seed(5))
    base = TrainConfig(batch_size=TRAIN_BATCH)
    times = {}
    for what, cfg in (
            ("off", base),
            ("update", dataclasses.replace(base, is_prune=True,
                                           prune_frequency=1)),
            ("apply", dataclasses.replace(base, is_prune=True,
                                          prune_frequency=10 ** 9))):
        net = build_network("yolo_mobilev1", spec.in_hw, spec.nanchors,
                            spec.class_num, alpha=0.75,
                            generator=torch.Generator().manual_seed(0))
        state = TT.create_train_state(net, cfg, device)
        step = TT.make_train_step(spec, cfg, torch.bfloat16,
                                  train_epoch_step=1000)
        times[what] = time_ms(lambda: step(state, images, labels), 10)
    params = dict(state.net.named_parameters())
    masks = state.masks
    n_w = sum(m.numel() for m in masks.values())
    upd = time_ms(lambda: P.update_masks(params, masks, 0.9), 20)
    app = time_ms(lambda: P.apply_masks(params, masks), 50)
    # the same with the thresholds' index and weight tables copied from
    # pageable memory: each such copy waits for the stream's queued work
    pinned = P._to_device
    P._to_device = lambda a, dev: torch.from_numpy(a).to(dev)
    try:
        upd_sync = time_ms(lambda: P.update_masks(params, masks, 0.9), 20)
        step = TT.make_train_step(
            spec, dataclasses.replace(cfg, prune_frequency=1),
            torch.bfloat16, train_epoch_step=1000)
        step_sync = time_ms(lambda: step(state, images, labels), 10)
    finally:
        P._to_device = pinned
    print(f"entry points: train step b{TRAIN_BATCH} bf16: pruning off "
          f"{times['off']:.3f} ms; pruning on, mask-update step "
          f"{times['update']:.3f} ms, mask-apply step {times['apply']:.3f} "
          f"ms; update_masks alone {upd:.3f} ms, apply_masks alone "
          f"{app:.4f} ms ({len(masks)} kernels, {n_w} weights) {tag}")
    print(f"entry points: with pageable copies in the thresholds (a host "
          f"sync each): update_masks alone {upd_sync:.3f} ms, mask-update "
          f"step {step_sync:.3f} ms {tag}")
    return times, upd, app


def masks_card_vs_cpu(device, nets):
    """``update_masks`` on the card against the CPU, mask for mask, on
    each (label, state dict, sparsities); a differing entry is printed with
    its distance from the threshold."""
    import torch

    from k210_yolo_framework_tpu_torch.training import pruning as P
    from k210_yolo_framework_tpu_torch.training.checkpoint import native_key

    for label, sd, sparsities in nets:
        cpu = {n: v.float() for n, v in sd.items() if P.is_prunable(n, v)}
        card = {n: v.to(device) for n, v in cpu.items()}
        names = {n: None for n in cpu}
        for s in sparsities:
            a = P.update_masks(card, names, s)
            b = P.update_masks(cpu, names, s)
            thr = P._thresholds([torch.sort(cpu[n].abs().reshape(-1)).values
                                 for n in names], np.float32(s))
            differ = 0
            for i, n in enumerate(names):
                diff = a[n].cpu() != b[n]
                for w in cpu[n][diff][:5].tolist():
                    print(f"  mask differs: {native_key(n, 4)} |w| {abs(w)!r}"
                          f" threshold {float(thr[i])!r}")
                differ += int(diff.sum())
            kept = sum(int(m.sum()) for m in b.values())
            print(f"entry points: update_masks card vs CPU, {label}, "
                  f"sparsity {s}: {len(names)} kernels, {kept} weights kept, "
                  f"{differ} masks differ")
            if differ:
                raise AssertionError("update_masks on the card differs from "
                                     "the CPU")


def entry_points_phase(device, tag, ann, keep_dir):
    """Phase 16: make_anchor_list, keras_train (pruned, profiled,
    recalibrated, then resumed), keras_inference and keras_eval, run in
    this process as a user would run them, against the library calls.
    Copies the trained ``yolo_prune_model.npz`` and the anchors into
    ``keep_dir`` for phase 17 and returns their paths."""
    import os
    import re
    import shutil

    import torch

    from k210_yolo_framework_tpu_torch import YoloSpec
    from k210_yolo_framework_tpu_torch.cli import keras_eval as KE
    from k210_yolo_framework_tpu_torch.cli import keras_inference as KI
    from k210_yolo_framework_tpu_torch.cli import keras_train as KT
    from k210_yolo_framework_tpu_torch.cli import make_anchor_list as MA
    from k210_yolo_framework_tpu_torch.data.annotations import read_image
    from k210_yolo_framework_tpu_torch.eval import evaluate_map
    from k210_yolo_framework_tpu_torch.inference import Predictor
    from k210_yolo_framework_tpu_torch.models import build_network
    from k210_yolo_framework_tpu_torch.ops import rotate_pallas as TR
    from k210_yolo_framework_tpu_torch.ops import yolo_head_pallas as TH
    from k210_yolo_framework_tpu_torch.training import checkpoint as CK
    from k210_yolo_framework_tpu_torch.utils.tboard import read_events

    t_phase = time.perf_counter()
    here = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        os.makedirs(f"{root}/data")
        np.save(f"{root}/data/{CLI_SET}_img_ann.npy", ann)
        os.chdir(root)
        try:
            rc, _ = captured(lambda: MA.main(MA.parse_args(
                [CLI_SET, "--is_plot", "False"])))
            anchors = np.load(f"data/{CLI_SET}_anchor.npy")
            if rc != 0 or anchors.shape != (2, 3, 2) or \
                    not np.isfinite(anchors).all():
                raise AssertionError(f"make_anchor_list: rc {rc}, {anchors}")

            # ---- keras_train: pruned, profiled, recalibrated -------------
            TR.rotate_3shear.launches = 0
            t0 = time.perf_counter()
            run, text = captured(lambda: KT.main(KT.parse_args(
                CLI_TRAIN + ["--max_nrof_epochs", "2", "--profile", "True",
                             "--bn_recalibrate", "2", "--log_dir", "log1"])))
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            launches = TR.rotate_3shear.launches
            print(f"entry points: keras_train (2 epochs of 3 steps, b64 "
                  f"bf16, pruned): rotate kernel launches {launches}; wall "
                  f"{train_s:.1f} s {tag}")
            if launches != 6:
                raise AssertionError("the rotate kernel did not run once "
                                     "per train step of keras_train")
            rates = re.findall(r"epoch (\d+) done in ([\d.]+)s \((\d+) "
                               r"img/s\)", text)
            for ep, sec, rate in rates:
                print(f"entry points: keras_train epoch {ep}: {rate} img/s "
                      f"({sec} s, its own line) {tag}")
            if len(rates) != 2 or "val_loss" not in text:
                raise AssertionError("keras_train: no epoch / validation "
                                     "line")
            checked = 0
            with np.load(run / "yolo_prune_model.npz") as z:
                for k in z.files:
                    n = z[k].size
                    if k.endswith("/kernel") and n >= 1000:
                        zero = float((z[k] == 0).mean())
                        if abs(zero - PRUNE_FINAL) > 1.0 / n + 1e-3:
                            raise AssertionError(f"{k}: zero share {zero}")
                        checked += 1
            lines = [json.loads(l) for l in
                     (run / "scalars.jsonl").read_text().splitlines()]
            events = [e for e in read_events(
                str(next(run.glob("events.out.tfevents.*"))))
                if e["scalars"]]
            steps = [d["step"] for d in lines]
            if steps != list(range(1, 7)) or \
                    [e["step"] for e in events] != steps or \
                    not all("sparsity" in e["scalars"] for e in events):
                raise AssertionError(f"scalars {steps}, events "
                                     f"{[e['step'] for e in events]}")
            traces = list((run / "profile").glob("*.json"))
            trace = traces[0].read_text() if len(traces) == 1 else ""
            if ROT_TRACE_NAME not in trace:
                raise AssertionError("keras_train --profile: no trace naming "
                                     "the rotate kernel")
            print(f"entry points: yolo_prune_model.npz: {checked} kernels "
                  f"of >= 1000 weights at {PRUNE_FINAL} +- 1/n + 1e-3; "
                  f"sparsity by step "
                  f"{[round(d['sparsity'], 4) for d in lines]}; scalars and "
                  f"events at steps {steps}; trace {traces[0].name} "
                  f"({len(trace) / 2**20:.1f} MiB) names {ROT_TRACE_NAME} "
                  f"{trace.count(ROT_TRACE_NAME)} times")

            TR.rotate_3shear.launches = 0
            resumed, text = captured(lambda: KT.main(KT.parse_args(
                CLI_TRAIN + ["--max_nrof_epochs", "1", "--pre_ckpt",
                             str(run / "ckpt"), "--log_dir", "log2"])))
            steps = [json.loads(l)["step"] for l in
                     (resumed / "scalars.jsonl").read_text().splitlines()]
            print(f"entry points: keras_train --pre_ckpt {run.name}/ckpt: "
                  f"steps {steps}, rotate kernel launches "
                  f"{TR.rotate_3shear.launches}")
            if steps != [7, 8, 9] or TR.rotate_3shear.launches != 3:
                raise AssertionError("keras_train did not resume the step "
                                     "count")

            weights = str(run / "yolo_prune_model.npz")
            spec = YoloSpec.from_files(f"data/{CLI_SET}_anchor.npy")
            net = build_network("yolo_mobilev1", spec.in_hw, spec.nanchors,
                                spec.class_num, alpha=0.75)
            init = {k: v.clone() for k, v in net.state_dict().items()}
            sd = CK.load_variables(weights, "yolo_mobilev1", net)
            masks_card_vs_cpu(device, (("seeded net", init, (0.5, 0.9)),
                                       ("trained net", sd, (0.95,))))

            # ---- keras_inference ---------------------------------------
            image = str(ann[0][0])
            probe = Predictor(net, sd, spec, obj_thresh=0.01,
                              compute_dtype=torch.bfloat16, device=device)
            scores = np.sort(probe.predict_image(read_image(image)).scores)
            thresh = float(scores[-min(10, len(scores))]) * 0.999 \
                if len(scores) else 0.01
            TH.fused_decode_nms.launches = 0
            t0 = time.perf_counter()
            det, text = captured(lambda: KI.main(KI.parse_args(
                CLI_NET + ["--bf16", "True", "--obj_thresh", str(thresh),
                           "--output", f"{root}/det.png", weights, image])))
            inf_s = time.perf_counter() - t0
            launches = TH.fused_decode_nms.launches
            want = Predictor(net, sd, spec, obj_thresh=thresh,
                             compute_dtype=torch.bfloat16,
                             device=device).predict_image(read_image(image))
            printed = [l for l in text.splitlines()
                       if re.match(r"^\[-?[\d.]+\t", l)]
            print(f"entry points: keras_inference (obj_thresh {thresh:.4f}):"
                  f" {len(printed)} rows, head kernel launches {launches}; "
                  f"wall {inf_s:.3f} s for one image {tag}")
            if launches != 1 or printed != table_lines(want) or \
                    not printed or not all(
                        np.array_equal(a, b) for a, b in zip(det, want)):
                raise AssertionError("keras_inference's table differs from "
                                     "Predictor.predict_image")

            # ---- keras_eval, keras_eval.py's defaults -------------------
            TH.fused_decode_nms.launches = 0
            res, text = captured(lambda: KE.main(KE.parse_args(
                [weights] + CLI_NET)))
            launches = TH.fused_decode_nms.launches
            ref = evaluate_map(Predictor(net, sd, spec, **EVAL,
                                         compute_dtype=torch.float32,
                                         device=device),
                               ann, spec.class_num, batch_size=EVAL_BATCH)
            n_batches = -(-len(ann) // EVAL_BATCH)
            print(f"entry points: keras_eval ({len(ann)} images, b"
                  f"{EVAL_BATCH} fp32, obj_thresh 0.01, max_out 100): mAP "
                  f"{res['map']!r}, evaluate_map {ref['map']!r}; head kernel "
                  f"launches {launches}; {res['imgs_per_s']:.1f} imgs/s "
                  f"{tag}")
            if launches != n_batches or res["map"] != ref["map"] or \
                    not np.isfinite(res["map"]):
                raise AssertionError("keras_eval's mAP differs from "
                                     "evaluate_map")
            kept = (shutil.copy(weights, keep_dir),
                    shutil.copy(f"data/{CLI_SET}_anchor.npy", keep_dir))
        finally:
            os.chdir(here)
    prune_step_times(device, tag, ann)
    print(f"entry points: wall seconds {time.perf_counter() - t_phase:.1f}")
    return kept


# ---- 17. quantized serving, the export, keras_freeze, Helper -----------------
# the five serving modes: None and the Predictor's quantize modes
QUANT_MODES = (None, "int8", "int8_act", "int8_act_sym", "int8_act_cal")
CALIB_ROWS = 32            # phase 8's JPEGs that calibrate int8_act_cal
EXPORT_BATCH = 8           # the export NMS's [B, C, N, N] IoU at N = 1050
# tests/test_quantize.py:77-78's bounds of a quantized box against the
# unquantized one: same class, IoU >= 0.7, score within 0.1
MATCH_IOU, MATCH_SCORE = 0.7, 0.1
# card against CPU in the int8-activation modes: an ulp between cuDNN's and
# the CPU's fp32 convs flips an activation's rounding now and then, one
# quantum each, which moves the logits by up to ~1% of their largest
# (tests/test_torch_quantize.py: the port against JAX).  So each int8 conv
# is held to the CPU bit for bit on the card's own input, and the
# detections to the CPU within twice the CPU's own spread when every conv
# weight moves by one ulp (unmatched detections and matched score
# difference; never tighter than detmatch's defaults)
SPREAD_ENVELOPE = 2.0
# (builder, alpha, layers, modes, batch): the zp-padded SAME 3x3 path
# (tiny_yolo, yolo) and v2 under int8 weights and int8 activations (its
# 124-channel convs through the zero-padded int8 product)
QUANT_BUILDERS = (("tiny_yolo", 1.0, 2, ("int8_act", "int8_act_cal"), 32),
                  ("yolo", 1.0, 3, ("int8_act", "int8_act_cal"), 32),
                  ("yolo_mobilev2", 0.75, 2, ("int8", "int8_act"), 128))


def match_rate(ref, got) -> tuple:
    """(matched, total): ``ref``'s detections with a detection of ``got``
    of the same class, IoU >= MATCH_IOU and score within MATCH_SCORE."""
    from k210_yolo_framework_tpu_torch.utils.detmatch import match_stats

    from k210_yolo_framework_tpu_torch.inference import stack_detections

    un, total, _ = match_stats(stack_detections(ref), stack_detections(got),
                               MATCH_IOU, MATCH_SCORE)
    return total - un, total


def int8_convs_card_vs_cpu(pred, canvases, hws) -> list:
    """Run ``pred`` (an int8-activation mode) on the canvases, capturing
    each int8 conv's input: the conv, and its int8 product
    (``torch._int_mm``) on the same quantized operands, card against CPU,
    exactly.  Returns the scopes of the convs checked."""
    import copy

    import torch

    from k210_yolo_framework_tpu_torch.models.layers import Conv

    captured = []
    real_conv, real_product = Conv.forward_int8, Conv._int8_product

    def capture_conv(self, x, act):
        y = real_conv(self, x, act)
        captured.append((self, x, act, y))
        return y

    def capture_product(self, xq, wq, *cout):
        products.append((self, xq, wq, cout))
        return real_product(self, xq, wq, *cout)

    products = []
    Conv.forward_int8 = capture_conv
    Conv._int8_product = capture_product
    try:
        pred.predict_batch(canvases, hws)
    finally:
        Conv.forward_int8, Conv._int8_product = real_conv, real_product
    for conv, xq, wq, cout in products:
        if not torch.equal(real_product(conv, xq, wq, *cout).cpu(),
                           real_product(conv, xq.cpu(), wq.cpu(), *cout)):
            raise AssertionError(f"{conv.scope}: _int_mm on the card "
                                 "differs from the CPU")
    for conv, x, act, y in captured:
        cpu = copy.deepcopy(conv).cpu()
        if not torch.equal(y.cpu(), real_conv(cpu, x.cpu(), act)):
            raise AssertionError(f"{conv.scope}: the int8 conv on the card "
                                 "differs from the CPU on the same input")
    if len(captured) != len(products):
        raise AssertionError("int8 convs and products do not pair up")
    return [conv.scope for conv, *_ in products]


def nudged_state(net):
    """``net``'s state with every conv kernel one ulp up."""
    import torch

    return {k: torch.nextafter(v, torch.full_like(v, float("inf")))
            if k.endswith(".weight") and v.ndim == 4 else v.clone()
            for k, v in net.state_dict().items()}


def quantized_serving(device, tag, ann, spec, net, canvases, hws, image):
    """The five modes of phase 4's served net at B=128 bf16 on the three
    scenes: head launches, rate, latency, profile, weight bytes; the int8
    products and each mode's detections card against CPU; the match rate
    against the unquantized Predictor.  Returns the head launches."""
    import torch

    from k210_yolo_framework_tpu_torch.eval import calibrate_from_rows
    from k210_yolo_framework_tpu_torch.inference import (
        Predictor,
        stack_detections,
    )
    from k210_yolo_framework_tpu_torch.ops import yolo_head_pallas as TH
    from k210_yolo_framework_tpu_torch.utils.detmatch import (
        assert_detections_close,
        match_stats,
    )

    c_dev = torch.from_numpy(canvases).to(device)
    h_dev = torch.from_numpy(hws).to(device)
    calib = ann[:CALIB_ROWS]
    dense = dense_state(net, spec)
    serve = dict(iou_thresh=IOU, compute_dtype=torch.bfloat16, device=device)
    scenes = (("sparse", None, 0.7), ("mid", None, MID_THRESH),
              ("dense", dense, 0.7))
    results, head_launches = {}, 0
    for mode in QUANT_MODES:
        label = mode or "none"
        preds = {name: Predictor(net, st, spec, obj_thresh=t, quantize=mode,
                                 **serve) for name, st, t in scenes}
        if mode == "int8_act_cal":
            t0 = time.perf_counter()
            for p in preds.values():
                calibrate_from_rows(p, calib)
            print(f"quantized {label}: calibrated on {len(calib)} JPEGs "
                  f"(512x512 canvases) in {time.perf_counter() - t0:.2f} s "
                  "for three Predictors")
        TH.fused_decode_nms.launches = 0
        served = {name: (p.predict_batch(canvases, hws),
                         p.predict_image(image)) for name, p in preds.items()}
        torch.cuda.synchronize()
        launches = TH.fused_decode_nms.launches
        head_launches += launches
        if launches != 2 * len(scenes):
            raise AssertionError(f"{label}: head kernel launched {launches} "
                                 "times, expected one per serving call")
        for name, (dets, one) in served.items():
            for d in dets + [one]:
                if not (np.isfinite(d.scores).all()
                        and (d.scores >= preds[name].obj_thresh).all()
                        and d.boxes.shape == (len(d.scores), 4)):
                    raise AssertionError(f"{label} {name}: malformed "
                                         "detections")
        if sum(len(d.scores) for d in served["dense"][0]) == 0:
            raise AssertionError(f"{label}: no dense-scene detections")
        results[label] = served
        # the head kernel against its plain version on the same logits
        # (launches of this check are not counted)
        held = []
        for name, p in preds.items():
            with torch.inference_mode():
                logits = p._forward_batch(c_dev, h_dev)
                got = p._head(logits, h_dev)
            want = TH.fused_decode_nms_reference(logits, spec, h_dev,
                                                 p.obj_thresh, IOU, p.max_out)
            err, flip = compare_heads(got, want, p.obj_thresh)
            held.append(f"{name} {int(got.valid.sum())} kept, max abs err "
                        f"{err:.3g}, {flip} borderline flips")
        print(f"quantized {label}: b{BATCH} head kernel vs plain head on "
              f"the same logits: {'; '.join(held)}")

        pred = preds["sparse"]
        serve_ms = time_ms(lambda: pred._run_batch(c_dev, h_dev), 10)
        b1_ms = time_ms(lambda: pred._run_batch(c_dev[:1], h_dev[:1]), 20)
        n_kernels, dev_ms, by_cat, _ = kernel_profile(
            lambda: pred._run_batch(c_dev, h_dev), iters=2)
        elem = by_cat["elementwise/other"]
        print(f"quantized {label:<12}: serve b{BATCH} bf16 {serve_ms:.3f} "
              f"ms/batch = {BATCH * 1e3 / serve_ms:.1f} imgs/s; b1 latency "
              f"{b1_ms:.3f} ms; profile b{BATCH}: {n_kernels:g} kernels/call,"
              f" device {dev_ms:.3f} ms/call (busy share "
              f"{dev_ms / serve_ms:.3f}), elementwise/other {elem:.3f} ms "
              f"({elem / max(dev_ms, 1e-9):.1%}), conv/matmul "
              f"{by_cat['conv/matmul']:.3f} ms, head kernel "
              f"{by_cat['head kernel']:.3f} ms; weights on the card "
              f"{pred.weight_bytes()} bytes {tag}")

        # card against the CPU plain path, fp32 (TF32 off), 8 images
        part = slice(BATCH // 2 - 4, BATCH // 2 + 4)
        small = dict(obj_thresh=0.2, iou_thresh=0.45, quantize=mode)
        act = bool(mode) and mode.startswith("int8_act")
        runs = [(device, None), ("cpu", None)]
        if act:
            runs.append(("cpu", nudged_state(net)))
        preds_ = [Predictor(net, st, spec, device=d, **small)
                  for d, st in runs]
        if mode == "int8_act_cal":
            for p in preds_:
                calibrate_from_rows(p, calib)
        set_tol = {}
        if act:
            n = len(int8_convs_card_vs_cpu(preds_[0], canvases[part],
                                           hws[part]))
            print(f"quantized {label}: {n} int8 convs card vs CPU on the "
                  "card's inputs, and their int8 products (_int_mm), "
                  "exactly equal")
        dets = [stack_detections(p.predict_batch(canvases[part], hws[part]))
                for p in preds_]
        if act:
            un = max(match_stats(dets[1], dets[2])[0],
                     match_stats(dets[2], dets[1])[0])
            ds = match_stats(dets[1], dets[2])[2]
            total = max(1, int(dets[1].valid.sum()))
            set_tol = dict(
                score_tol=max(1e-3, SPREAD_ENVELOPE * ds),
                max_flip_frac=max(0.005, SPREAD_ENVELOPE * un / total))
            print(f"quantized {label}: the CPU's own spread under one-ulp "
                  f"weights: {un} of {total} detections unmatched, largest "
                  f"matched score difference {ds:.3g}")
        un, total, ds = match_stats(dets[0], dets[1])
        n_a, n_b = assert_detections_close(dets[0], dets[1], **set_tol)
        print(f"quantized {label}: fp32 card vs CPU (8 images, obj_thresh "
              f"0.2): {n_a} vs {n_b} detections match ({un} unmatched, "
              f"largest matched score difference {ds:.3g}; bounds "
              f"{set_tol or 'detmatch defaults'})")

    for label in QUANT_MODES[1:]:
        for name in ("mid", "dense"):
            m, total = match_rate(results["none"][name][0],
                                  results[label][name][0])
            print(f"quantized {label:<12} vs bf16, {name} scene: {m}/{total}"
                  f" boxes matched (IoU >= {MATCH_IOU}, score within "
                  f"{MATCH_SCORE}) = {m / max(total, 1):.3f}")
    return head_launches


def quantized_builders(device, tag, ann, canvases, hws):
    """tiny_yolo and the darknet53 yolo in int8_act and int8_act_cal at
    B=32, yolo_mobilev2 in int8 at B=128: one head launch a call,
    detections against the plain head on the same logits, rate.  Returns
    the head launches."""
    import torch

    from k210_yolo_framework_tpu_torch.eval import calibrate_from_rows
    from k210_yolo_framework_tpu_torch.inference import (
        Predictor,
        stack_detections,
    )
    from k210_yolo_framework_tpu_torch.models import build_network
    from k210_yolo_framework_tpu_torch.ops import yolo_head_pallas as TH
    from k210_yolo_framework_tpu_torch.utils.detmatch import (
        assert_detections_close,
    )

    total = 0
    for name, alpha, layers, modes, bsz in QUANT_BUILDERS:
        spec = builder_spec(layers)
        net = build_network(name, spec.in_hw, spec.nanchors, spec.class_num,
                            alpha=alpha,
                            generator=torch.Generator().manual_seed(0))
        c_dev = torch.from_numpy(canvases[:bsz]).to(device)
        h_dev = torch.from_numpy(hws[:bsz]).to(device)
        for mode in modes:
            pred = Predictor(net, None, spec, obj_thresh=MID_THRESH,
                             iou_thresh=IOU, compute_dtype=torch.bfloat16,
                             quantize=mode, device=device)
            if mode == "int8_act_cal":
                calibrate_from_rows(pred, ann[:CALIB_ROWS])
            TH.fused_decode_nms.launches = 0
            dets = pred.predict_batch(canvases[:bsz], hws[:bsz])
            torch.cuda.synchronize()
            launches = TH.fused_decode_nms.launches
            total += launches
            if launches != 1:
                raise AssertionError(f"{name} {mode}: the head kernel did "
                                     "not run once")
            with torch.inference_mode():
                logits = pred._forward_batch(c_dev, h_dev)
            want = TH.fused_decode_nms_reference(logits, spec, h_dev,
                                                 MID_THRESH, IOU, 30)
            n_a, n_b = assert_detections_close(stack_detections(dets),
                                               to_np(want))
            ms = time_ms(lambda: pred._run_batch(c_dev, h_dev), 5)
            print(f"quantized {name} {mode}: b{bsz} bf16 {ms:.3f} ms/batch "
                  f"= {bsz * 1e3 / ms:.1f} imgs/s; {n_a} detections (plain "
                  f"head on its logits {n_b}); weights on the card "
                  f"{pred.weight_bytes()} bytes {tag}")
    return total


def export_phase(device, tag, spec, net, canvases, hws, tmp):
    """yolo_serving.pt2 of the bf16 and the int8 Predictor on the 0.7 and
    the mid scene, saved, loaded and run on the card in batches of
    EXPORT_BATCH: equal to the live Predictor at set level; rate and file
    sizes."""
    import torch

    from k210_yolo_framework_tpu_torch.export import export_serving
    from k210_yolo_framework_tpu_torch.inference import (
        Predictor,
        stack_detections,
    )
    from k210_yolo_framework_tpu_torch.ops.nms import NmsResult
    from k210_yolo_framework_tpu_torch.utils.detmatch import (
        assert_detections_close,
    )

    c_dev = torch.from_numpy(canvases).to(device)
    h_dev = torch.from_numpy(hws).to(device)
    for mode, thresh in ((None, 0.7), ("int8", 0.7), (None, MID_THRESH),
                         ("int8", MID_THRESH)):
        label = f"{mode or 'bf16'} obj_thresh {thresh}"
        pred = Predictor(net, None, spec, obj_thresh=thresh, iou_thresh=IOU,
                         compute_dtype=torch.bfloat16, quantize=mode,
                         device=device)
        t0 = time.perf_counter()
        path = Path(tmp) / f"yolo_serving_{mode}_{thresh}.pt2"
        torch.export.save(export_serving(pred, batch=EXPORT_BATCH,
                                         canvas_hw=CANVAS_HW), path)
        program = torch.export.load(path).module()
        built = time.perf_counter() - t0

        def run():
            parts = [program(c_dev[i:i + EXPORT_BATCH],
                             h_dev[i:i + EXPORT_BATCH])
                     for i in range(0, BATCH, EXPORT_BATCH)]
            return NmsResult(*(torch.cat(t) for t in zip(*parts)))

        got = run()
        n_a, n_b = assert_detections_close(
            to_np(got), stack_detections(pred.predict_batch(canvases, hws)))
        ms = time_ms(run, 3, warmup=1)
        print(f"export {label}: yolo_serving.pt2 {path.stat().st_size} "
              f"bytes, exported and loaded in {built:.1f} s; on the card "
              f"(b{EXPORT_BATCH} programs over {BATCH} canvases) "
              f"{BATCH * 1e3 / ms:.1f} imgs/s; {n_a} detections, live "
              f"Predictor {n_b} {tag}")


def quantized_scripts(device, tag, ann, weights, anchors):
    """keras_freeze, keras_inference --quantize int8_act_cal and keras_eval
    --quantize int8 --calib_list, in this process in a working directory,
    each against the library calls it wraps."""
    import os
    import re

    import torch

    from k210_yolo_framework_tpu_torch import YoloSpec
    from k210_yolo_framework_tpu_torch.cli import keras_eval as KE
    from k210_yolo_framework_tpu_torch.cli import keras_freeze as KF
    from k210_yolo_framework_tpu_torch.cli import keras_inference as KI
    from k210_yolo_framework_tpu_torch.data.annotations import read_image
    from k210_yolo_framework_tpu_torch.data.pipeline import stage_image
    from k210_yolo_framework_tpu_torch.eval import evaluate_map
    from k210_yolo_framework_tpu_torch.export import ServingProgram
    from k210_yolo_framework_tpu_torch.inference import Predictor
    from k210_yolo_framework_tpu_torch.models import build_network
    from k210_yolo_framework_tpu_torch.ops import yolo_head_pallas as TH
    from k210_yolo_framework_tpu_torch.training import checkpoint as CK

    here = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        os.makedirs(f"{root}/data")
        np.save(f"{root}/data/{CLI_SET}_img_ann.npy", ann[:64])
        np.save(f"{root}/data/calib_img_ann.npy", ann[64:128])
        np.save(f"{root}/data/{CLI_SET}_anchor.npy", np.load(anchors))
        os.chdir(root)
        try:
            spec = YoloSpec.from_files(f"data/{CLI_SET}_anchor.npy")
            net = build_network("yolo_mobilev1", spec.in_hw, spec.nanchors,
                                spec.class_num, alpha=0.75)
            sd = CK.load_variables(weights, "yolo_mobilev1", net)

            # ---- keras_freeze -------------------------------------------
            t0 = time.perf_counter()
            arts, text = captured(lambda: KF.main(KF.parse_args(
                [weights] + CLI_NET + ["--out_dir", f"{root}/frz"])))
            frz_s = time.perf_counter() - t0
            nodes = [l for l in text.splitlines() if "Node:" in l]
            if not {"program", "serving", "npz"} <= set(arts) or \
                    len(nodes) != 3:
                raise AssertionError(f"keras_freeze: {arts}, {nodes}")
            # the program takes canvases of the net's input size
            canvas, hw = stage_image(read_image(str(ann[0][0])), spec.in_hw)
            c1 = torch.from_numpy(canvas[None]).to(device)
            h1 = torch.from_numpy(hw[None]).to(device)
            got = torch.export.load(arts["serving"]).module()(c1, h1)
            with torch.inference_mode():
                want = ServingProgram(Predictor(net, sd, spec,
                                                device=device))(c1, h1)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError("keras_freeze's yolo_serving.pt2 "
                                     "differs from the Predictor's program")
            sizes = {k: Path(v).stat().st_size for k, v in arts.items()}
            print(f"quantized scripts: keras_freeze wrote {sizes} (bytes) in "
                  f"{frz_s:.1f} s; its serving program equals the "
                  f"Predictor's on the card {tag}")

            # ---- keras_inference --quantize int8_act_cal ---------------
            image = str(ann[0][0])
            pixels = read_image(image)
            probe = Predictor(net, sd, spec, obj_thresh=0.01,
                              compute_dtype=torch.bfloat16,
                              quantize="int8_act_cal", device=device)
            probe.calibrate(pixels[None], np.asarray([pixels.shape[:2]],
                                                     np.int32))
            scores = np.sort(probe.predict_image(pixels).scores)
            thresh = float(scores[-min(10, len(scores))]) * 0.999 \
                if len(scores) else 0.01
            TH.fused_decode_nms.launches = 0
            det, text = captured(lambda: KI.main(KI.parse_args(
                CLI_NET + ["--bf16", "True", "--quantize", "int8_act_cal",
                           "--obj_thresh", str(thresh), "--output",
                           f"{root}/det.png", weights, image])))
            launches = TH.fused_decode_nms.launches
            want = Predictor(net, sd, spec, obj_thresh=thresh,
                             compute_dtype=torch.bfloat16,
                             quantize="int8_act_cal", device=device)
            want.calibrate(pixels[None], np.asarray([pixels.shape[:2]],
                                                    np.int32))
            want = want.predict_image(pixels)
            printed = [l for l in text.splitlines()
                       if re.match(r"^\[-?[\d.]+\t", l)]
            print(f"quantized scripts: keras_inference --quantize "
                  f"int8_act_cal (obj_thresh {thresh:.4f}): {len(printed)} "
                  f"rows, head kernel launches {launches}")
            if launches != 1 or printed != table_lines(want) or \
                    not printed or not all(
                        np.array_equal(a, b) for a, b in zip(det, want)):
                raise AssertionError("keras_inference --quantize differs "
                                     "from Predictor.predict_image")

            # ---- keras_eval --quantize int8 --calib_list -----------------
            TH.fused_decode_nms.launches = 0
            res, _ = captured(lambda: KE.main(KE.parse_args(
                [weights] + CLI_NET + ["--quantize", "int8", "--calib_list",
                                       "data/calib_img_ann.npy"])))
            launches = TH.fused_decode_nms.launches
            ref = evaluate_map(Predictor(net, sd, spec, **EVAL,
                                         compute_dtype=torch.float32,
                                         quantize="int8", device=device),
                               ann[:64], spec.class_num,
                               batch_size=EVAL_BATCH)
            print(f"quantized scripts: keras_eval --quantize int8 (64 "
                  f"images, b{EVAL_BATCH} fp32): mAP {res['map']!r}, "
                  f"evaluate_map {ref['map']!r}; head kernel launches "
                  f"{launches}; {res['imgs_per_s']:.1f} imgs/s {tag}")
            if launches != 64 // EVAL_BATCH or res["map"] != ref["map"] or \
                    not np.isfinite(res["map"]):
                raise AssertionError("keras_eval --quantize int8's mAP "
                                     "differs from evaluate_map")
        finally:
            os.chdir(here)


def helper_phase(device, ann, anchors, tmp) -> int:
    """compat.Helper on the card: one batch of set_dataset, and
    _process_img(is_training=True) with a draw that rotates (one rotation
    launch).  Returns the rotation launches."""
    import torch

    from k210_yolo_framework_tpu_torch.compat import Helper
    from k210_yolo_framework_tpu_torch.ops import augment as TA
    from k210_yolo_framework_tpu_torch.ops import rotate_pallas as TR

    np.save(f"{tmp}/helper_ann.npy", ann[:40])
    h = Helper(f"{tmp}/helper_ann.npy", 20, anchors, (224, 320),
               np.array([[7, 10], [14, 20]]), validation_split=0.2,
               device=device)
    h.set_dataset(batch_size=16, rand_seed=3, is_training=True)
    imgs, labels = next(h.train_dataset)
    if imgs.device.type != torch.device(device).type or \
            imgs.shape != (16, 224, 320, 3) or \
            labels[0].shape != (16, 7, 10, 3, 25):
        raise AssertionError(f"Helper.set_dataset: {imgs.shape} on "
                             f"{imgs.device}")
    seed = next(s for s in range(100) if int(TA.draw_params(
        1, (224, 320), "iid", torch.Generator().manual_seed(s)).branch[0])
        == TA.ROTATE)
    row = h.train_list[0]
    TR.rotate_3shear.launches = 0
    out, boxes = h._process_img(h._read_img(str(row[0])), np.copy(row[1]),
                                is_training=True,
                                generator=torch.Generator().manual_seed(seed))
    launches = TR.rotate_3shear.launches
    print(f"Helper: set_dataset batch {tuple(imgs.shape)} on "
          f"{imgs.device}; _process_img(is_training=True) (rotation drawn): "
          f"rotate kernel launches {launches}, {len(boxes)} boxes, max "
          f"{out.max():.3f}")
    if launches != 1 or out.shape != (224, 320, 3) or not np.isfinite(
            out).all():
        raise AssertionError("Helper._process_img did not rotate through "
                             "the kernel")
    return launches


def quantized_phase(device, tag, ann, spec, net, canvases, hws, image,
                    weights, anchors):
    """Phase 17.  Returns (head launches, rotation launches) of its main
    paths."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        head = quantized_serving(device, tag, ann, spec, net, canvases, hws,
                                 image)
        print(f"quantized serving: wall seconds "
              f"{time.perf_counter() - t0:.1f}")
        t0 = time.perf_counter()
        head += quantized_builders(device, tag, ann, canvases, hws)
        print(f"quantized builders: wall seconds "
              f"{time.perf_counter() - t0:.1f}")
        t0 = time.perf_counter()
        export_phase(device, tag, spec, net, canvases, hws, tmp)
        print(f"export: wall seconds {time.perf_counter() - t0:.1f}")
        t0 = time.perf_counter()
        quantized_scripts(device, tag, ann, weights, anchors)
        print(f"quantized scripts: wall seconds "
              f"{time.perf_counter() - t0:.1f}")
        rot = helper_phase(device, ann, anchors, tmp)
    return head, rot


# ---- 18. any candidate count, the stem modes, data-parallel serving ---------
# the darknet53 yolo at YOLOv3's own 608x608 (N = 22,743: the rows go to the
# greedy kernels' global path) and at 1088x1088 (N = 72,828, past 16-bit
# candidate indices)
BIG_SIDE, HUGE_SIDE = 608, 1088
BIG_BATCH = 8
BIG_CPU_BATCH = 2          # fp32, card against the port on the CPU
# bf16 detections of two programs that round alike but sum in another
# order (the patches stem's product against cuDNN's conv): matched scores
# within 4e-3, at most 2 flips per 100 (tests/test_torch_predictor.py)
BF16_SET_TOL = dict(score_tol=4e-3, max_flip_frac=0.02)
# a stem input against the default letterbox: at most one level, in at
# most PIXEL_SHARE of the values (the preprocess tolerance above)
STEM_LEVELS = 1
# (builder, alpha, stem modes) of the stem phase, each at B=128 bf16
STEM_BUILDERS = (("yolo_mobilev1", 0.75, ("default", "patches",
                                          "nativeconv")),
                 ("yolo_mobilev2", 0.75, ("default", "patches")))


def counts():
    """(head launches, head global, NMS launches, NMS global); the head's
    launches in score order are ``fused_decode_nms.ordered_launches``."""
    from k210_yolo_framework_tpu_torch.ops import nms_pallas as TN
    from k210_yolo_framework_tpu_torch.ops import yolo_head_pallas as TH

    return (TH.fused_decode_nms.launches, TH.fused_decode_nms.global_launches,
            TN.batched_nms_pallas.launches,
            TN.batched_nms_pallas.global_launches)


def zero_counts() -> None:
    from k210_yolo_framework_tpu_torch.ops import nms_pallas as TN
    from k210_yolo_framework_tpu_torch.ops import yolo_head_pallas as TH

    for fn in (TH.fused_decode_nms, TN.batched_nms_pallas):
        fn.launches = fn.global_launches = 0
    TH.fused_decode_nms.ordered_launches = 0


def scratch_line(lib_fn, bsz, n, classes, rows) -> str:
    blocks = bsz * -(-classes // rows)
    per = lib_fn(n, rows)
    return f"scratch {per} B a block x {blocks} blocks = {per * blocks} B"


def time_nms(name, boxes, scores, thresh, max_out, tag):
    """NMS alone against its plain version (plain, kernel, kernel, plain),
    on the card alone, and its bound; returns the times as a dict."""
    from k210_yolo_framework_tpu_torch.ops import nms_pallas as TN

    kw = dict(max_out=max_out, iou_thresh=IOU)
    plain = lambda: TN._select(boxes, scores, stop_below=thresh, **kw)  # noqa: E731
    kern = lambda: TN._launch(boxes, scores, score_thresh=thresh, **kw)  # noqa: E731
    k_ms, p_ms, (p1, k1, k2, p2) = alternating(plain, kern, 2, 5)
    dev_k = device_ms(kern, 5)
    live = live_tests(lambda lv: TN._select(boxes, scores, stop_below=thresh,
                                            live=lv, **kw))
    bsz, n, classes = scores.shape
    b_ms, by = nms_bound(bsz, n, classes, max_out, live)
    layout, rows = TN._plan(boxes.device, bsz, n, classes)
    where = (scratch_line(TN._kernel_lib().nms_scratch_bytes, bsz, n,
                          classes, rows)
             if layout == "global" else "shared memory")
    print(f"nms b{bsz} {name} (N={n}, thresh {thresh}, {layout} layout, "
          f"G={rows}, {where}): kernel {k1:.4f}/{k2:.4f} ms a launch by events, {dev_k:.4f} ms "
          f"with launches queued; plain {p1:.4f}/{p2:.4f} ms; bound "
          f"{b_ms:.4f} ms ({by}, {live} live candidate tests, "
          f"{per_test(dev_k, live)}) {tag}")
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
                device_ms=dev_k)


def global_path_kernels(device, tag, spec, logits, h_dev, scenes):
    """The head and NMS kernels on the global path against their plain
    versions: at N=22,743 on the served yolo's own B=8 logits of each scene
    (head by ``compare_heads``, NMS bit for bit; the NMS kernel once per
    two-stage call on the main path), and at N=72,828 (B=1) on random
    logits.  Returns (NMS launches, NMS global launches, the head's and
    NMS's times at N=22,743 on the mid scene)."""
    import torch

    from k210_yolo_framework_tpu_torch.ops import decode as TD
    from k210_yolo_framework_tpu_torch.ops import nms_pallas as TN
    from k210_yolo_framework_tpu_torch.ops import yolo_head_pallas as TH

    n = sum(h * w for h, w in spec.out_hws) * spec.nanchors
    for name, p in scenes:
        if TH._plan(device, logits[name][0].shape[0], n,
                    spec.class_num)[0] != "global":
            raise AssertionError(f"N={n}: not on the global path")
    head_t, nms_t = {}, {}
    for name, p in scenes:
        head_t[name] = time_head(f"yolo{BIG_SIDE} {name}", spec,
                                 logits[name], h_dev, p.obj_thresh, 30, IOU,
                                 device, tag, plain_iters=2, kern_iters=5)

    # the two-stage head: decode_outputs -> the NMS kernel, one call a scene
    decoded = {k: TD.decode_outputs(logits[k], spec, h_dev) for k, _ in scenes}
    zero_counts()
    two = {k: TN.batched_nms_pallas(*decoded[k], p.obj_thresh, IOU, 30)
           for k, p in scenes}
    torch.cuda.synchronize()
    _, _, nms_launches, nms_global = counts()
    print(f"yolo{BIG_SIDE} two-stage: NMS kernel launches {nms_launches} "
          f"({nms_global} on the global path) in {len(scenes)} calls")
    if nms_launches != len(scenes) or nms_global != len(scenes):
        raise AssertionError("the NMS kernel did not run once per two-stage "
                             "call on the global path")
    for name, p in scenes:
        boxes, scores = decoded[name]
        want = TN.batched_nms_pallas_reference(boxes, scores, p.obj_thresh,
                                               IOU, 30)
        diff = n_differing(two[name], want)
        print(f"yolo{BIG_SIDE} nms kernel vs plain: {name:<6} N={n} kept="
              f"{int(two[name].valid.sum())} elements_differing={diff}")
        if diff:
            raise AssertionError("the NMS kernel differs from its plain "
                                 "version on the global path")
        nms_t[name] = time_nms(f"yolo{BIG_SIDE} {name}", boxes, scores,
                               p.obj_thresh, 30, tag)

    # past 16-bit indices: one image of 1088x1088, rows of many steps
    huge = builder_spec(3, (HUGE_SIDE, HUGE_SIDE))
    n_huge = sum(h * w for h, w in huge.out_hws) * huge.nanchors
    rng = np.random.default_rng(7)
    preds = [torch.from_numpy((rng.normal(0, 2, (1, h, w, 3, 25)) + np.r_[
        [0.0] * 4, [1.5] * 21]).astype(np.float32)).to(device)
        for h, w in huge.out_hws]
    hw1 = torch.tensor([[900, 1200]], dtype=torch.int32, device=device)
    got = TH.fused_decode_nms(preds, huge, hw1, 0.5, IOU, 30)
    want = TH.fused_decode_nms_reference(preds, huge, hw1, 0.5, IOU, 30)
    err, flip = compare_heads(got, want, 0.5)
    boxes, scores = TD.decode_outputs(preds, huge, hw1)
    got_n = TN.batched_nms_pallas(boxes, scores, 0.5, IOU, 30)
    diff = n_differing(got_n, TN.batched_nms_pallas_reference(
        boxes, scores, 0.5, IOU, 30))
    print(f"N={n_huge} (yolo {HUGE_SIDE}x{HUGE_SIDE}, B=1): head kernel "
          f"vs plain max_abs_err={err:.3g} borderline_flips={flip}, kept "
          f"{int(got.valid.sum())}; NMS kernel vs plain elements_differing="
          f"{diff}, kept {int(got_n.valid.sum())}")
    if diff or n_huge <= 65_535 or not bool(got.valid.any()):
        raise AssertionError(f"N={n_huge}: the kernels disagree with their "
                             "plain versions")
    time_head(f"yolo{HUGE_SIDE} b1", huge, preds, hw1, 0.5, 30, IOU, device,
              tag, plain_iters=2, kern_iters=5)
    time_nms(f"yolo{HUGE_SIDE} b1", boxes, scores, 0.5, 30, tag)
    k_ms, p_ms, b_ms, by, dev_k = head_t["mid"]
    head_global = dict(n=n, batch=BIG_BATCH, scene="mid", ms=k_ms,
                       plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
                       device_ms=dev_k)
    return nms_launches, nms_global, head_global, dict(
        n=n, batch=BIG_BATCH, scene="mid", **nms_t["mid"])


def big_yolo_scripts(device, tag, ann, net, spec, scene_thresh):
    """keras_inference on one JPEG and keras_eval on one batch of 8, the
    darknet53 yolo at 608x608, as a user runs them; each against the
    library.  Returns the head launches (and those on the global path)."""
    import os
    import re

    import torch

    from k210_yolo_framework_tpu_torch.cli import keras_eval as KE
    from k210_yolo_framework_tpu_torch.cli import keras_inference as KI
    from k210_yolo_framework_tpu_torch.data.annotations import read_image
    from k210_yolo_framework_tpu_torch.eval import evaluate_map
    from k210_yolo_framework_tpu_torch.inference import Predictor
    from k210_yolo_framework_tpu_torch.training import checkpoint as CK

    size = ["--image_size", str(BIG_SIDE), str(BIG_SIDE), "--output_size"] \
        + [str(BIG_SIDE // st) for st in (32, 16, 8) for _ in (0, 1)]
    args = ["--train_set", CLI_SET, "--class_num", "20", "--model_def",
            "yolo", "--device", "cuda"] + size
    here = os.getcwd()
    launches = [0, 0]
    with tempfile.TemporaryDirectory() as root:
        os.makedirs(f"{root}/data")
        np.save(f"{root}/data/{CLI_SET}_img_ann.npy", ann[:BIG_BATCH])
        np.save(f"{root}/data/{CLI_SET}_anchor.npy", spec.anchors_np())
        weights = f"{root}/yolo{BIG_SIDE}.npz"
        CK.save_npz(weights, net)
        os.chdir(root)
        try:
            image = str(ann[0][0])
            zero_counts()
            t0 = time.perf_counter()
            det, text = captured(lambda: KI.main(KI.parse_args(
                args + ["--bf16", "True", "--obj_thresh", str(scene_thresh),
                        "--output", f"{root}/det.png", weights, image])))
            inf_s = time.perf_counter() - t0
            head, head_global, _, _ = counts()
            want = Predictor(net, None, spec, obj_thresh=scene_thresh,
                             iou_thresh=0.3, compute_dtype=torch.bfloat16,
                             device=device).predict_image(read_image(image))
            printed = [l for l in text.splitlines()
                       if re.match(r"^\[-?[\d.]+\t", l)]
            print(f"yolo{BIG_SIDE}: keras_inference (obj_thresh "
                  f"{scene_thresh}): {len(printed)} rows, head kernel "
                  f"launches {head} ({head_global} on the global path); "
                  f"wall {inf_s:.3f} s {tag}")
            if head != 1 or head_global != 1 or not printed or \
                    printed != table_lines(want) or not all(
                        np.array_equal(a, b) for a, b in zip(det, want)):
                raise AssertionError("keras_inference at 608x608 differs "
                                     "from Predictor.predict_image")
            launches[0] += head
            launches[1] += head_global

            zero_counts()
            res, _ = captured(lambda: KE.main(KE.parse_args(
                [weights] + args + ["--batch_size", str(BIG_BATCH),
                                    "--limit", str(BIG_BATCH)])))
            head, head_global, _, _ = counts()
            ref = evaluate_map(Predictor(net, None, spec, **EVAL,
                                         compute_dtype=torch.float32,
                                         device=device),
                               ann[:BIG_BATCH], spec.class_num,
                               batch_size=BIG_BATCH)
            print(f"yolo{BIG_SIDE}: keras_eval (one batch of {BIG_BATCH}, "
                  f"fp32, obj_thresh 0.01, max_out 100): mAP {res['map']!r}, "
                  f"evaluate_map {ref['map']!r}; head kernel launches {head} "
                  f"({head_global} on the global path); "
                  f"{res['imgs_per_s']:.1f} imgs/s {tag}")
            if head != 1 or head_global != 1 or res["map"] != ref["map"] \
                    or not np.isfinite(res["map"]):
                raise AssertionError("keras_eval at 608x608 differs from "
                                     "evaluate_map")
            launches[0] += head
            launches[1] += head_global
        finally:
            os.chdir(here)
    return tuple(launches)


def big_yolo(device, tag, ann, canvases, hws, image):
    """The darknet53 yolo at 608x608 (N=22,743) served in bf16 at B=8
    through ``predict_batch`` and ``predict_image`` in the 0.7, mid and
    dense scenes (the head on its global path once per call), its rate,
    fp32 card against the port on the CPU at set level, the kernels on the
    global path, and the two scripts.  Returns ((head launches, on the
    global path), (NMS launches, on the global path), head and NMS times on
    the global path)."""
    import torch

    from k210_yolo_framework_tpu_torch.inference import (
        Predictor,
        stack_detections,
    )
    from k210_yolo_framework_tpu_torch.models import build_network
    from k210_yolo_framework_tpu_torch.ops import yolo_head_pallas as TH
    from k210_yolo_framework_tpu_torch.utils.detmatch import (
        assert_detections_close,
    )

    spec = builder_spec(3, (BIG_SIDE, BIG_SIDE))
    n = sum(h * w for h, w in spec.out_hws) * spec.nanchors
    net = build_network("yolo", spec.in_hw, spec.nanchors, spec.class_num,
                        generator=torch.Generator().manual_seed(0))
    serve = dict(iou_thresh=IOU, compute_dtype=torch.bfloat16, device=device)
    scenes = (("sparse", Predictor(net, None, spec, obj_thresh=0.7, **serve)),
              ("mid", Predictor(net, None, spec, obj_thresh=MID_THRESH,
                                **serve)),
              ("dense", Predictor(net, dense_state(net, spec), spec,
                                  obj_thresh=0.7, **serve)))
    c8, h8 = canvases[:BIG_BATCH], hws[:BIG_BATCH]
    zero_counts()
    served = {k: (p.predict_batch(c8, h8), p.predict_image(image))
              for k, p in scenes}
    torch.cuda.synchronize()
    head, head_global, _, _ = counts()
    ordered = TH.fused_decode_nms.ordered_launches
    print(f"yolo{BIG_SIDE}: N={n}, serving B={BIG_BATCH} bf16: head kernel "
          f"launches {head} ({head_global} on the global path, {ordered} in "
          f"score order) in {2 * len(scenes)} calls; plan "
          f"{TH._plan(device, BIG_BATCH, n, spec.class_num)}")
    if head != 2 * len(scenes) or head_global != head or ordered != head:
        raise AssertionError("the head kernel did not run on the global path "
                             "in score order once per serving call")
    c_dev = torch.from_numpy(c8).to(device)
    h_dev = torch.from_numpy(h8).to(device)
    img_t = torch.from_numpy(image).to(device)
    hw1 = torch.tensor([image.shape[:2]], dtype=torch.int32, device=device)
    logits = {}
    for name, p in scenes:
        dets, one = served[name]
        with torch.inference_mode():
            inputs = ((p._forward_batch(c_dev, h_dev), h_dev, dets),
                      (p._forward(p._letterbox_for_stem(
                          img_t[None], hw1, torch.float32)), hw1, [one]))
        for what, (preds, hws_, dets_) in zip(("batch", "image"), inputs):
            want = TH.fused_decode_nms_reference(preds, spec, hws_,
                                                 p.obj_thresh, IOU, 30)
            err, flip = compare_heads(p._head(preds, hws_), want,
                                      p.obj_thresh)
            n_a, n_b = assert_detections_close(stack_detections(dets_),
                                               to_np(want))
            print(f"yolo{BIG_SIDE}: {name:<6} {what}: served {n_a} "
                  f"detections, plain head {n_b}; same forward "
                  f"max_abs_err={err:.3g} borderline_flips={flip}")
            if name != "sparse" and n_a == 0:
                raise AssertionError(f"yolo{BIG_SIDE} {name}: no detections")
        logits[name] = inputs[0][0]
    pred = scenes[0][1]
    serve_ms = time_ms(lambda: pred._run_batch(c_dev, h_dev), 10)
    b1_ms = time_ms(lambda: pred._run_batch(c_dev[:1], h_dev[:1]), 10)
    print(f"yolo{BIG_SIDE}: serve b{BIG_BATCH} bf16 {serve_ms:.3f} ms/batch "
          f"= {BIG_BATCH * 1e3 / serve_ms:.1f} imgs/s; b1 latency "
          f"{b1_ms:.3f} ms {tag}")

    small = dict(obj_thresh=0.2, iou_thresh=0.45, compute_dtype=torch.float32)
    cut = slice(0, BIG_CPU_BATCH)
    a = Predictor(net, None, spec, device=device, **small).predict_batch(
        c8[cut], h8[cut])
    b = Predictor(net, None, spec, device="cpu", **small).predict_batch(
        c8[cut], h8[cut])
    n_a, n_b = assert_detections_close(stack_detections(a),
                                       stack_detections(b))
    print(f"yolo{BIG_SIDE}: fp32 card vs the port on the CPU "
          f"({BIG_CPU_BATCH} images, obj_thresh 0.2): {n_a} vs {n_b} "
          f"detections match (detmatch defaults)")
    if n_a == 0:
        raise AssertionError("no detections to hold card against CPU")

    nms, nms_global, head_t, nms_t = global_path_kernels(
        device, tag, spec, logits, h_dev, scenes)
    s_head, s_global = big_yolo_scripts(device, tag, ann, net, spec,
                                        MID_THRESH)
    return ((head + s_head, head_global + s_global), (nms, nms_global),
            head_t, nms_t)


def unfold_patches(imgs):
    """[B, H, W, C] -> [B, Ho, 3, Wo, 3, C], the 3x3 stride-2 stem's
    zero-padded patches, by ``unfold``."""
    import torch.nn.functional as F

    xp = F.pad(imgs, (0, 0, 1, 1, 1, 1))
    return xp.unfold(1, 3, 2).unfold(2, 3, 2).permute(0, 1, 4, 2, 5, 3)


def stem_modes(device, tag, canvases, hws, image):
    """Each builder of STEM_BUILDERS served at B=128 bf16 on the mid scene
    in each of its stem modes: the net's input against ``unfold`` of the
    default letterbox's canvas, the detections against the default's as
    sets, one head launch a call, imgs/s, b1 latency and a kernel profile.
    Returns the head launches."""
    import torch

    from k210_yolo_framework_tpu_torch.inference import (
        Predictor,
        stack_detections,
    )
    from k210_yolo_framework_tpu_torch.models import build_network
    from k210_yolo_framework_tpu_torch.ops import letterbox as LB
    from k210_yolo_framework_tpu_torch.utils.detmatch import (
        assert_detections_close,
    )

    c_dev = torch.from_numpy(canvases).to(device)
    h_dev = torch.from_numpy(hws).to(device)
    head = 0
    for name, alpha, modes in STEM_BUILDERS:
        spec = builder_spec(2)
        net = build_network(name, spec.in_hw, spec.nanchors, spec.class_num,
                            alpha=alpha,
                            generator=torch.Generator().manual_seed(0))
        with torch.inference_mode():
            canvas = LB.letterbox_image(c_dev, h_dev, spec.in_hw,
                                        torch.bfloat16).to(torch.uint8)
            want_patches = unfold_patches(canvas)
        base = None
        for mode in modes:
            p = Predictor(net, None, spec, obj_thresh=MID_THRESH,
                          iou_thresh=IOU, compute_dtype=torch.bfloat16,
                          stem_mode=mode, device=device)
            with torch.inference_mode():
                x = p._letterbox_for_stem(c_dev, h_dev, torch.bfloat16)
                ref = want_patches if mode == "patches" else canvas
                if x.shape != ref.shape:
                    raise AssertionError(f"{name} {mode}: input "
                                         f"{tuple(x.shape)}")
                d = (x.int() - ref.int()).abs()
                n_diff, d_max = int((d > 0).sum()), int(d.max())
            print(f"stem {name} {mode:<10}: input {tuple(x.shape)} against "
                  f"{'unfold of ' if mode == 'patches' else ''}the default "
                  f"letterbox's canvas: {n_diff} of {d.numel()} values "
                  f"differ, by at most {d_max} levels")
            if d_max > STEM_LEVELS or n_diff > PIXEL_SHARE * d.numel():
                raise AssertionError(f"{name} {mode}: the stem input "
                                     "departs from the default letterbox")
            zero_counts()
            dets = p.predict_batch(canvases, hws)
            one = p.predict_image(image)
            torch.cuda.synchronize()
            launches = counts()[0]
            head += launches
            if launches != 2:
                raise AssertionError(f"{name} {mode}: the head kernel did "
                                     "not run once per serving call")
            if base is None:
                base = (dets, one)
                n_a = sum(len(d_.scores) for d_ in dets)
                n_b = n_a
            else:
                n_a, n_b = assert_detections_close(
                    stack_detections(dets), stack_detections(base[0]),
                    **BF16_SET_TOL)
                assert_detections_close(stack_detections([one]),
                                        stack_detections([base[1]]),
                                        **BF16_SET_TOL)
            if n_a == 0:
                raise AssertionError(f"{name} {mode}: no detections")
            serve_ms = time_ms(lambda: p._run_batch(c_dev, h_dev), 20)
            b1_ms = time_ms(lambda: p._run_batch(c_dev[:1], h_dev[:1]), 20)
            n_kernels, dev_ms, by_cat, top = kernel_profile(
                lambda: p._run_batch(c_dev, h_dev), iters=3)
            print(f"stem {name} {mode:<10}: {n_a} detections (default "
                  f"{n_b}); serve b{BATCH} bf16 {serve_ms:.3f} ms/batch = "
                  f"{BATCH * 1e3 / serve_ms:.1f} imgs/s; b1 latency "
                  f"{b1_ms:.3f} ms; profile b{BATCH}: {n_kernels:g} "
                  f"kernels/call, device {dev_ms:.3f} ms/call, conv/matmul "
                  f"{by_cat['conv/matmul']:.3f} ms, elementwise/other "
                  f"{by_cat['elementwise/other']:.3f} ms {tag}")
            for kname, ms, count in top[:4]:
                print(f"  {ms:8.3f} ms  x{count:<4g} {kname[:100]}")
    return head


def nativeconv_int8_stem(device, tag, ann, canvases, hws):
    """yolo_mobilev1 alpha 0.75 under ``int8_act_cal`` in the ``default``
    and ``nativeconv`` stem modes, calibrated: in ``nativeconv`` the
    3-channel stem computes int8 and holds a calibrated range.  At B=128
    bf16 on the mid scene: one head launch a call, the head kernel against
    the plain head on its logits, imgs/s; then fp32 on 8 images, every
    int8 conv (the stem among them) and its int8 product card against CPU
    on the card's own inputs, exactly.  Returns the head launches."""
    import torch

    from k210_yolo_framework_tpu_torch.eval import calibrate_from_rows
    from k210_yolo_framework_tpu_torch.inference import Predictor
    from k210_yolo_framework_tpu_torch.models import build_network
    from k210_yolo_framework_tpu_torch.ops import yolo_head_pallas as TH

    spec = builder_spec(2)
    net = build_network("yolo_mobilev1", spec.in_hw, spec.nanchors,
                        spec.class_num, alpha=0.75,
                        generator=torch.Generator().manual_seed(0))
    calib = ann[:CALIB_ROWS]
    c_dev = torch.from_numpy(canvases).to(device)
    h_dev = torch.from_numpy(hws).to(device)
    head, served = 0, {}
    for mode in ("default", "nativeconv"):
        p = Predictor(net, None, spec, obj_thresh=MID_THRESH, iou_thresh=IOU,
                      compute_dtype=torch.bfloat16, quantize="int8_act_cal",
                      stem_mode=mode, device=device)
        calibrate_from_rows(p, calib)
        stem = p.net.stem.conv
        if stem.int8_capable != (mode == "nativeconv"):
            raise AssertionError(f"int8_act_cal {mode}: the stem is "
                                 f"{'' if stem.int8_capable else 'not '}int8")
        rng = (f"calibrated stem range [{float(stem.act_min):.6g}, "
               f"{float(stem.act_max):.6g}]" if stem.int8_capable
               else "the stem wide")
        if stem.int8_capable and not stem.act_max > stem.act_min:
            raise AssertionError("nativeconv: the stem has no calibrated "
                                 "range")
        zero_counts()
        dets = p.predict_batch(canvases, hws)
        torch.cuda.synchronize()
        launches = counts()[0]
        head += launches
        n_dets = sum(len(d.scores) for d in dets)
        if launches != 1 or n_dets == 0:
            raise AssertionError(f"int8_act_cal {mode}: {launches} head "
                                 f"launches, {n_dets} detections")
        served[mode] = dets
        with torch.inference_mode():
            logits = p._forward_batch(c_dev, h_dev)
            got = p._head(logits, h_dev)
        want = TH.fused_decode_nms_reference(logits, spec, h_dev,
                                             p.obj_thresh, IOU, p.max_out)
        err, flip = compare_heads(got, want, p.obj_thresh)
        serve_ms = time_ms(lambda: p._run_batch(c_dev, h_dev), 20)
        print(f"stem int8_act_cal {mode:<10}: {rng}; {n_dets} detections; "
              f"head kernel vs plain head on the same logits: max abs err "
              f"{err:.3g}, {flip} borderline flips; serve b{BATCH} bf16 "
              f"{serve_ms:.3f} ms/batch = {BATCH * 1e3 / serve_ms:.1f} "
              f"imgs/s {tag}")
    m, total = match_rate(served["default"], served["nativeconv"])
    print(f"stem int8_act_cal nativeconv vs default, mid scene: {m}/{total} "
          f"boxes matched (IoU >= {MATCH_IOU}, score within {MATCH_SCORE})")

    part = slice(BATCH // 2 - 4, BATCH // 2 + 4)
    small = dict(obj_thresh=0.2, iou_thresh=0.45, quantize="int8_act_cal",
                 stem_mode="nativeconv")
    preds_ = [Predictor(net, None, spec, device=d, **small)
              for d in (device, "cpu")]
    for p in preds_:
        calibrate_from_rows(p, calib)
    ranges = [(float(p.net.stem.conv.act_min), float(p.net.stem.conv.act_max))
              for p in preds_]
    scopes = int8_convs_card_vs_cpu(preds_[0], canvases[part], hws[part])
    stem_scope = preds_[0].net.stem.conv.scope
    if stem_scope not in scopes:
        raise AssertionError(f"nativeconv: the stem {stem_scope} did not "
                             "run int8")
    print(f"stem int8_act_cal nativeconv: {len(scopes)} int8 convs, the stem "
          f"{stem_scope} (K=27) among them, card vs CPU on the card's inputs "
          f"(fp32, 8 images), and their int8 products (_int_mm), exactly "
          f"equal; calibrated stem range card {ranges[0]}, CPU {ranges[1]}")
    return head


def data_parallel(device, tag, canvases, hws):
    """``make_sharded_runner(make_mesh())`` over a world-size-1 NCCL group
    at B=128 bf16 on the mid scene, bit for bit against ``_run_batch``,
    with its rate.  The machine has one GPU: no multi-GPU number is taken.
    Returns the head launches."""
    import torch
    import torch.distributed as dist

    from k210_yolo_framework_tpu_torch.inference import Predictor
    from k210_yolo_framework_tpu_torch.models import build_network
    from k210_yolo_framework_tpu_torch.parallel import make_mesh

    spec = builder_spec(2)
    net = build_network("yolo_mobilev1", spec.in_hw, spec.nanchors,
                        spec.class_num, alpha=0.75,
                        generator=torch.Generator().manual_seed(0))
    pred = Predictor(net, None, spec, obj_thresh=MID_THRESH, iou_thresh=IOU,
                     compute_dtype=torch.bfloat16, device=device)
    c_dev = torch.from_numpy(canvases).to(device)
    h_dev = torch.from_numpy(hws).to(device)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/init",
                                world_size=1, rank=0)
        try:
            mesh = make_mesh()
            runner = pred.make_sharded_runner(mesh)
            zero_counts()
            got = runner(c_dev, h_dev)
            torch.cuda.synchronize()
            launches = counts()[0]
            want = pred._run_batch(c_dev, h_dev)
            diff = n_differing(got, want)
            dp_ms = time_ms(lambda: runner(c_dev, h_dev), 20)
            local_ms = time_ms(lambda: pred._run_batch(c_dev, h_dev), 20)
            print(f"data parallel: mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
                  f"(NCCL, world size 1: this machine has one GPU, so no "
                  f"multi-GPU rate is taken); runner at B={BATCH} bf16: head "
                  f"kernel launches {launches}, {int(got.valid.sum())} "
                  f"detections, elements differing from _run_batch {diff}; "
                  f"{dp_ms:.3f} ms/batch = {BATCH * 1e3 / dp_ms:.1f} imgs/s "
                  f"against _run_batch {local_ms:.3f} ms = "
                  f"{BATCH * 1e3 / local_ms:.1f} imgs/s {tag}")
            if launches != 1 or diff or not bool(got.valid.any()):
                raise AssertionError("the sharded runner differs from "
                                     "_run_batch")
        finally:
            dist.destroy_process_group()
    return launches


def any_n_stems_and_dp_phase(device, tag, ann, canvases, hws, image):
    """Phase 18.  Returns ((head launches, on the global path), (NMS
    launches, on the global path), head and NMS times on the global
    path)."""
    t0 = time.perf_counter()
    head, nms, head_t, nms_t = big_yolo(device, tag, ann, canvases, hws,
                                        image)
    t1 = time.perf_counter()
    stem = stem_modes(device, tag, canvases, hws, image)
    stem += nativeconv_int8_stem(device, tag, ann, canvases, hws)
    t2 = time.perf_counter()
    dp = data_parallel(device, tag, canvases, hws)
    print(f"phase 18: wall seconds: yolo {BIG_SIDE} {t1 - t0:.1f}, stem "
          f"modes {t2 - t1:.1f}, data parallel "
          f"{time.perf_counter() - t2:.1f}")
    return (head[0] + stem + dp, head[1]), nms, head_t, nms_t


MESH_STEPS = 3     # fit's train steps in phase 19, with and without a mesh
MESH_TIMED = 10    # mesh and plain step timings, each (plain, mesh x2, plain)


def host_collectives(fn, iters: int) -> list:
    """The host side of ``fn``'s collectives under torch.profiler: each
    CPU event whose name holds "allreduce" or "all_reduce", as (name,
    calls per call of fn, host ms per call of fn, its total including what
    it calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [(ev.key, ev.count / iters, ev.cpu_time_total / 1e3 / iters)
            for ev in prof.key_averages()
            if any(k in ev.key.lower() for k in ("allreduce", "all_reduce"))]


def state_differences(a, b) -> list:
    """What differs, bit for bit, between two TrainStates of the same net:
    the state dict's tensors (parameters, BN running statistics), each
    parameter's Adam state (moments and step), the masks, the step."""
    import torch

    sa, sb = a.net.state_dict(), b.net.state_dict()
    diff = [f"net {k}" for k in sa if not torch.equal(sa[k], sb[k])]
    pb = dict(b.net.named_parameters())
    for name, p in a.net.named_parameters():
        mine, theirs = a.optimizer.state[p], b.optimizer.state[pb[name]]
        if sorted(mine) != sorted(theirs):
            diff.append(f"adam {name}: {sorted(mine)} vs {sorted(theirs)}")
            continue
        diff += [f"adam {name} {k}" for k in mine
                 if not torch.equal(mine[k], theirs[k])]
    diff += [f"mask {k}" for k in a.masks
             if not torch.equal(a.masks[k], b.masks[k])]
    if a.step != b.step:
        diff.append(f"step {a.step} vs {b.step}")
    return diff


def rel_l1(a, b, skip=()) -> float:
    """The worst parameter's sum|a - b| / sum|b| over two nets or two dicts
    of tensors (tests/test_parallel_equivalence.py's statistic), the names
    in ``skip`` left out."""
    a, b = (dict(x.named_parameters()) if hasattr(x, "named_parameters")
            else x for x in (a, b))
    return max(float((a[n].detach() - p.detach()).abs().sum()
                     / (p.detach().abs().sum() + 1e-12))
               for n, p in b.items() if n not in skip)


def mesh_training(device, tag, ann):
    """Phase 19: ``fit(mesh=make_mesh())`` over a world-size-1 NCCL group
    against ``fit`` without a mesh, 3 steps of yolo_mobilev1 (alpha 0.75)
    at B=128 in bf16 with augment on and 1 validation step, from the same
    weights, generator and host batches, with cuDNN on deterministic
    algorithms for both: parameters, BN running statistics, Adam moments
    and logged scalars bit for bit (else the differing tensors are printed
    and the two are held to 10x a batch-permutation control), one rotation
    launch a step; the mesh step against the plain step on one
    preprocessed batch (CUDA events, plain, mesh, mesh, plain) and a
    kernel profile of the mesh step with its NCCL share; then
    ``cli.keras_train --mesh auto`` in this process for 2 steps.  The
    machine has one GPU: no multi-GPU rate is taken.  Returns the rotation
    launches of the mesh runs."""
    import copy
    import os

    import torch
    import torch.distributed as dist

    from k210_yolo_framework_tpu_torch import voc_spec
    from k210_yolo_framework_tpu_torch.cli import keras_train as KT
    from k210_yolo_framework_tpu_torch.config import TrainConfig
    from k210_yolo_framework_tpu_torch.data import pipeline as PL
    from k210_yolo_framework_tpu_torch.data.annotations import (
        split_train_test,
    )
    from k210_yolo_framework_tpu_torch.models import build_network
    from k210_yolo_framework_tpu_torch.ops import rotate_pallas as TR
    from k210_yolo_framework_tpu_torch.parallel import init_world, make_mesh
    from k210_yolo_framework_tpu_torch.training import checkpoint as CK
    from k210_yolo_framework_tpu_torch.training import train as TT

    t_phase = time.perf_counter()
    spec = voc_spec()
    cfg = TrainConfig(batch_size=TRAIN_BATCH, max_epochs=1, augment=True)
    train_ann, test_ann = split_train_test(ann, 0.5)
    # decoded once: both runs take the same host batches
    it = iter(PL.DataPipeline(train_ann, TRAIN_BATCH, seed=0))
    batches = [next(it) for _ in range(MESH_STEPS)]
    it.close()
    it = iter(PL.DataPipeline(test_ann, TRAIN_BATCH, seed=1))
    test = next(it)
    it.close()
    net0 = build_network("yolo_mobilev1", spec.in_hw, spec.nanchors,
                         spec.class_num, alpha=0.75,
                         generator=torch.Generator().manual_seed(0))
    pp_train = PL.make_preprocess_fn(spec, True, torch.bfloat16)
    pp_test = PL.make_preprocess_fn(spec, False, torch.bfloat16)

    def run(mesh):
        scalars, lines = [], []
        state = TT.fit(copy.deepcopy(net0), spec, cfg, iter(batches),
                       iter([test]), pp_train, pp_test, MESH_STEPS, 1,
                       device=device,
                       generator=torch.Generator().manual_seed(cfg.rand_seed),
                       compute_dtype=torch.bfloat16, log_fn=lines.append,
                       scalar_logger=lambda s, d: scalars.append((s, d)),
                       mesh=mesh)
        torch.cuda.synchronize()
        return state, scalars, lines[-1].split("img/s)")[-1].strip()

    def permutation_control(plain_state):
        """rel_l1 of the plain trajectory against the same steps on each
        step's preprocessed batch with its halves swapped."""
        gen = torch.Generator().manual_seed(cfg.rand_seed)
        state = TT.create_train_state(copy.deepcopy(net0), cfg, device)
        step = TT.make_train_step(spec, cfg, torch.bfloat16)
        swap = torch.cat([torch.arange(TRAIN_BATCH // 2, TRAIN_BATCH),
                          torch.arange(TRAIN_BATCH // 2)]).to(device)
        for hb in batches:
            with torch.no_grad():
                images, labels = pp_train(*hb.to(device), gen)
            state, _ = step(state, images[swap], [l[swap] for l in labels])
        return rel_l1(state.net, plain_state.net)

    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        plain, p_scalars, p_val = run(None)
        with tempfile.TemporaryDirectory() as tmp:
            init_world("cuda", f"file://{tmp}/init", 0, 1)
            try:
                mesh = make_mesh()
                TR.rotate_3shear.launches = 0
                meshed, m_scalars, m_val = run(mesh)
                launches = TR.rotate_3shear.launches
                diff = state_differences(meshed, plain)
                same_logs = m_scalars == p_scalars and m_val == p_val
                n_adam = sum(len(v) for v in meshed.optimizer.state.values())
                print(f"mesh training: fit(mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}) "
                      f"over NCCL (world size 1: this machine has one GPU, "
                      f"so no multi-GPU rate is taken) against fit, "
                      f"{MESH_STEPS} steps b{TRAIN_BATCH} bf16 augment on: "
                      f"rotate kernel launches {launches}; "
                      f"{len(meshed.net.state_dict())} state tensors and "
                      f"{n_adam} Adam entries, differing {len(diff)}; "
                      f"logged scalars equal {m_scalars == p_scalars}, "
                      f"validation '{m_val}' vs '{p_val}'")
                if launches != MESH_STEPS:
                    raise AssertionError("the rotate kernel did not run once "
                                         "per mesh train step")
                if not all(np.isfinite(v) for _, d in m_scalars
                           for v in d.values()):
                    raise AssertionError(f"mesh scalars: {m_scalars}")
                if diff or not same_logs:
                    print(f"mesh training: not bit for bit; differing: "
                          f"{diff[:12]}")
                    err, ctl = (rel_l1(meshed.net, plain.net),
                                permutation_control(plain))
                    print(f"mesh training: parameters rel_l1 {err:.3g} "
                          f"against the permutation control's {ctl:.3g}")
                    if not err < 10 * max(ctl, 1e-6):
                        raise AssertionError("the mesh fit departs from fit "
                                             "beyond 10x the control")
                else:
                    print("mesh training: bit for bit equal to fit "
                          "(parameters, BN statistics, Adam moments and "
                          "steps, logged scalars, validation)")

                # the step alone on one preprocessed batch
                hb = batches[0].to(device)
                with torch.no_grad():
                    images, labels = pp_train(
                        *hb, generator=torch.Generator().manual_seed(3))
                plain_step = TT.make_train_step(spec, cfg, torch.bfloat16)
                mesh_step = TT.make_train_step(spec, cfg, torch.bfloat16,
                                               mesh=mesh)
                st = meshed
                p1, m1, m2, p2 = (
                    time_ms(lambda: plain_step(st, images, labels), MESH_TIMED),
                    time_ms(lambda: mesh_step(st, images, labels), MESH_TIMED),
                    time_ms(lambda: mesh_step(st, images, labels), MESH_TIMED),
                    time_ms(lambda: plain_step(st, images, labels), MESH_TIMED))
                print(f"mesh training: train step b{TRAIN_BATCH} bf16 on one "
                      f"preprocessed batch: mesh {m1:.3f}/{m2:.3f} ms, plain "
                      f"{p1:.3f}/{p2:.3f} ms (mesh - plain "
                      f"{(m1 + m2 - p1 - p2) / 2:+.3f} ms; cuDNN deterministic) {tag}")
                for label, fn, wall in (
                        ("mesh", lambda: mesh_step(st, images, labels),
                         (m1 + m2) / 2),
                        ("plain", lambda: plain_step(st, images, labels),
                         (p1 + p2) / 2)):
                    n_k, dev_ms, by_cat, top = kernel_profile(fn, iters=3)
                    if n_k == 0:
                        print(f"profile {label} step: the profiler recorded "
                              f"no device events; device time not measured "
                              f"{tag}")
                        continue
                    cats = ", ".join(f"{k} {v:.3f} ms"
                                     for k, v in by_cat.items())
                    print(f"profile {label} step b{TRAIN_BATCH} bf16: "
                          f"{n_k:g} kernels/step, device {dev_ms:.3f} ms of "
                          f"{wall:.3f} ms timed (busy share "
                          f"{dev_ms / wall:.3f}); NCCL share of device time "
                          f"{by_cat['nccl'] / dev_ms:.4f}; {cats} {tag}")
                    for name, ms, count in top[:4]:
                        print(f"  {ms:8.3f} ms  x{count:<4g} {name[:100]}")
                # where the mesh step's host time goes: its collectives
                for name, calls, ms in host_collectives(
                        lambda: mesh_step(st, images, labels), iters=3):
                    print(f"host collectives of the mesh step: {name} "
                          f"x{calls:g} a step, {ms:.3f} ms of host time a "
                          f"step (callees included) {tag}")
            finally:
                dist.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            flags

    # the entry point: keras_train --mesh auto joins its own world (one
    # process: one visible card) and trains 2 steps
    here = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        os.makedirs(f"{root}/data")
        np.save(f"{root}/data/{CLI_SET}_img_ann.npy", ann)
        np.save(f"{root}/data/{CLI_SET}_anchor.npy", np.asarray(spec.anchors))
        os.chdir(root)
        try:
            TR.rotate_3shear.launches = 0
            t0 = time.perf_counter()
            run_dir, text = captured(lambda: KT.main(KT.parse_args(
                CLI_NET + ["--mesh", "auto", "--batch_size", "64",
                           "--vaildation_split", "0.5", "--max_nrof_epochs",
                           "1", "--log_dir", "logm"])))
            torch.cuda.synchronize()
            cli_launches = TR.rotate_3shear.launches
            steps = [json.loads(line)["step"] for line in
                     (run_dir / "scalars.jsonl").read_text().splitlines()]
            state = TT.create_train_state(copy.deepcopy(net0), cfg, device)
            resumed = CK.restore_state(str(run_dir / "ckpt"), state).step
            print(f"mesh training: keras_train --mesh auto (b64 bf16): "
                  f"rotate kernel launches {cli_launches}, scalars at steps "
                  f"{steps}, ckpt at step {resumed}; wall "
                  f"{time.perf_counter() - t0:.1f} s {tag}")
            if "over 1 processes (nccl)" not in text or steps != [1, 2] \
                    or resumed != 2 or cli_launches != 2:
                raise AssertionError("keras_train --mesh auto did not train "
                                     "2 steps over NCCL")
        finally:
            os.chdir(here)
    print(f"phase 19: wall seconds {time.perf_counter() - t_phase:.1f}")
    return launches + cli_launches


# ---- 20-21. the model and space axes -------------------------------------
# NCCL refuses two ranks on one card, so each world is 2 or 4 processes on
# the one GPU joined by gloo, with the tensors on CUDA.  gloo on one card is
# no scaling number: its collectives stage through the host.
TPSP_WORLDS = ((1, 2, 1), (1, 1, 2), (1, 2, 2))
TPSP_TIMED = 3             # calls timed a rank, each
TPSP_RECAL = (2, 8)        # recalibration: batches, batch size
# a gradient leaf whose largest entry lies below this share of the largest
# gradient entry is at rounding level: a BatchNorm bias whose every path to
# the loss runs through a 1x1 conv and a train-mode BN (yolo_mobilev2's
# linear project BNs) has an exact gradient of 0, its relative L1 is noise
# against noise and Adam moves it by +-lr on that noise; such leaves are
# held to stay at rounding level and left out of the worst leaf
VANISHING = 1e-6


class TpspCase(NamedTuple):
    """One builder in every world: the runner's ``serve`` calls (dtype,
    batch); ``steps`` fp32 train steps at ``train_b`` (0: none), of the
    smooth witness and one of the net itself where ``witness``; a fused
    bf16 step at ``fused_b`` (0: none); with ``recalibrate``,
    ``recalibrate_batch_stats(mesh=)`` on dp2*sp2 and tp2*sp2 in the
    4-rank world; and phase 22's fp32 ``quantized`` serve calls
    (``TPSP_QUANTIZED`` name, batch)."""
    tag: str
    phase: int
    model: str
    alpha: float
    layers: int
    in_hw: tuple
    serve: tuple
    train_b: int = 0
    steps: int = 0
    witness: bool = False
    fused_b: int = 0
    recalibrate: bool = False
    quantized: tuple = ()


# Phase 22: the quantize and stem modes on the model and space axes, by
# name: (quantize, stem_mode)
TPSP_QUANTIZED = {"int8": ("int8", "default"),
                  "patches": (None, "patches"),
                  "patches_int8": ("int8", "patches"),
                  "int8_act": ("int8_act", "default"),
                  "int8_act_sym": ("int8_act_sym", "default"),
                  "int8_act_cal": ("int8_act_cal", "default"),
                  "nativeconv_int8_act": ("int8_act", "nativeconv")}
# the int8-activation modes' bound against the same Predictor's
# _run_batch, tests/test_torch_tpsp_quantize.py's pinned flip bound: at
# most 1% unmatched either way, matched scores within 2e-3 (a cuDNN
# algorithm on a slice moves an activation by ulps, which can flip its
# rounding); the float-weight modes at test_sharded_serving.py's 0.5% and
# 1e-3
TPSP_ACT_BOUND = (0.01, 2e-3)
TPSP_Q_B = 32              # phase 22's yolo_mobilev1 batch


# Phase 20: yolo_mobilev1, the main path's model and width.  Phase 21:
# yolo_mobilev2 at alpha 1.0 (its 160-channel blocks 14-15 sliced over
# model), tiny_yolo (at 224x320 its 7-row stride-32 grid is gathered before
# the stride-1 pool), the darknet53 yolo at 224x320 and at YOLOv3's 608x608
# (N = 22,743: the head's global path on every rank).  The yolo's batches
# are small: over gloo on one card each of its ~70 channel gathers a
# forward is staged through the host.
TPSP_CASES = (
    TpspCase("v1", 20, "yolo_mobilev1", 0.75, 2, (224, 320),
             (("fp32", 32), ("bf16", BATCH)), 32, 3, fused_b=BATCH,
             quantized=tuple((q, TPSP_Q_B) for q in TPSP_QUANTIZED)),
    TpspCase("v2", 21, "yolo_mobilev2", 1.0, 2, (224, 320), (("fp32", 8),),
             8, 2, witness=True, quantized=(("patches", 8),)),
    TpspCase("tiny", 21, "tiny_yolo", 1.0, 2, (224, 320), (("fp32", 8),),
             8, 2, witness=True, fused_b=32, recalibrate=True,
             quantized=(("int8_act", 8),)),
    TpspCase("yolo", 21, "yolo", 1.0, 3, (224, 320), (("fp32", 4),), 2, 2,
             witness=True, quantized=(("int8_act", 4),)),
    TpspCase("yolo608", 21, "yolo", 1.0, 3, (BIG_SIDE, BIG_SIDE),
             (("fp32", 2),)),
)


def tpsp_name(dims) -> str:
    return "*".join(f"{a}{n}" for a, n in zip(("dp", "tp", "sp"), dims)
                    if n > 1)


def set_level(got, want):
    """(unmatched of want in got, of want, unmatched of got in want, of
    got, the largest matched score difference):
    test_sharded_serving.py:93-105's statistic."""
    from k210_yolo_framework_tpu_torch.utils.detmatch import match_stats

    un_ab, n_a, ds_ab = match_stats(want, got)
    un_ba, n_b, ds_ba = match_stats(got, want)
    return un_ab, n_a, un_ba, n_b, max(ds_ab, ds_ba)


def within_share(un_ab, n_a, un_ba, n_b, share) -> bool:
    return (n_a > 0 and un_ab <= max(1, int(np.ceil(share * n_a)))
            and un_ba <= max(1, int(np.ceil(share * n_b))))


def counted_collectives(fn) -> dict:
    """The collectives of one call of ``fn`` in this process, by name."""
    import torch.distributed as dist

    seen = {}
    originals = {k: getattr(dist, k) for k in
                 ("all_gather", "all_reduce", "broadcast")}

    def counting(name):
        def call(*args, **kwargs):
            seen[name] = seen.get(name, 0) + 1
            return originals[name](*args, **kwargs)
        return call

    for k in originals:
        setattr(dist, k, counting(k))
    try:
        fn()
    finally:
        for k, f in originals.items():
            setattr(dist, k, f)
    return seen


def tpsp_rank(rank, world, init_file, dims, ann, out_dir):
    """One rank of a world: gloo over CUDA tensors on card 0."""
    import pickle

    import torch
    import torch.distributed as dist

    from k210_yolo_framework_tpu_torch.parallel import init_world

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # the plain step and its control repeat exactly (as in phase 19)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    init_world("cuda", f"file://{init_file}", rank, world, backend="gloo")
    try:
        seen = tpsp_work(dims, ann)
        Path(out_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(seen))
    finally:
        dist.destroy_process_group()


def tpsp_serve(mesh, net0, spec, label, bsz, canvases, hws, cfg=None,
               calib=None) -> dict:
    """``make_sharded_runner`` in ``label``'s dtype (phase 22: in the
    ``TPSP_QUANTIZED`` configuration ``cfg``, ``int8_act_cal`` calibrated
    on ``calib``, numpy (canvases, sizes)) against ``_run_batch`` on the
    card: the set-level statistic, the head launches of one call (and
    those on the global path), its all-reduces (the activation ranges'),
    the weight bytes the Predictor holds before and after the runner is
    made, the ms of a call."""
    import torch

    from k210_yolo_framework_tpu_torch.inference import Predictor
    from k210_yolo_framework_tpu_torch.ops.nms import NmsResult

    def host(res):
        return NmsResult(*(t.cpu().numpy() for t in res))

    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[label]
    quantize, stem_mode = TPSP_QUANTIZED[cfg] if cfg else (None, "default")
    pred = Predictor(net0, None, spec, obj_thresh=MID_THRESH, iou_thresh=IOU,
                     compute_dtype=dtype, quantize=quantize,
                     stem_mode=stem_mode, device=canvases.device)
    if quantize == "int8_act_cal":
        pred.calibrate(*calib)
    single_bytes = pred.weight_bytes()
    runner = pred.make_sharded_runner(mesh)
    c, h = canvases[:bsz], hws[:bsz]
    got = []
    zero_counts()
    coll = counted_collectives(lambda: got.append(runner(c, h)))
    torch.cuda.synchronize()
    launches, global_launches = counts()[:2]
    want = pred._run_batch(c, h)
    return dict(stats=set_level(host(got[0]), host(want)),
                valid_equal=bool(torch.equal(got[0].valid, want.valid)),
                launches=launches, global_launches=global_launches,
                all_reduces=coll.get("all_reduce", 0),
                bytes=(single_bytes, pred.weight_bytes()),
                n=sum(a * b for a, b in spec.out_hws) * spec.nanchors,
                ms=time_ms(lambda: runner(c, h), TPSP_TIMED, warmup=1))


def tpsp_train(mesh, net0, spec, hb, case) -> dict:
    """``make_train_step`` in fp32 at ``case.train_b``, ``case.steps``
    steps against the plain step and a batch-permutation control (cuDNN
    deterministic): the first step's gradients and the final parameters,
    worst leaf by relative L1 outside the leaves whose plain gradient is at
    rounding level (``VANISHING``), which are held to stay there.  Where
    ``case.witness`` the steps are the smooth witness's and one step of
    the net itself is held by its loss.  A further mesh step timed and its
    collectives counted."""
    import copy

    import torch

    from k210_yolo_framework_tpu_torch.config import TrainConfig
    from k210_yolo_framework_tpu_torch.data import pipeline as PL
    from k210_yolo_framework_tpu_torch.models.layers import (
        BatchNorm,
        smooth_witness,
    )
    from k210_yolo_framework_tpu_torch.training import train as TT

    device = torch.device("cuda", 0)
    bsz = case.train_b
    held = net0
    if case.witness:
        # BatchNorm's scales and biases drawn as tests/torch_parity.py
        # draws them, so no BN leaf is relative to init's zeros
        held = copy.deepcopy(net0)
        gen = torch.Generator().manual_seed(4)
        with torch.no_grad():
            for mod in held.modules():
                if isinstance(mod, BatchNorm):
                    mod.weight.copy_(torch.rand(mod.weight.shape,
                                                generator=gen) + 0.5)
                    mod.bias.copy_(torch.randn(mod.bias.shape,
                                               generator=gen) * 0.1)
        held = smooth_witness(held)
    cfg = TrainConfig(batch_size=bsz, augment=True)
    pp = PL.make_preprocess_fn(spec, True, torch.float32)
    with torch.no_grad():
        images, labels = pp(*PL.HostBatch(*(a[:bsz] for a in hb)).to(device),
                            generator=torch.Generator().manual_seed(3))
    swap = torch.cat([torch.arange(bsz // 2, bsz),
                      torch.arange(bsz // 2)]).to(device)

    def steps(net, m, n, order=None):
        state = TT.create_train_state(copy.deepcopy(net), cfg, device)
        if m is not None:
            TT.shard_state(state, m)
        step = TT.make_train_step(spec, cfg, mesh=m)
        x, y = images, labels
        if order is not None:
            x, y = images[order], [lab[order] for lab in labels]
        losses = []
        for i in range(n):
            state, logs = step(state, x, y)
            losses.append(float(logs["loss"]))
            if i == 0:
                grads = {k: p.grad.detach().clone()
                         for k, p in state.net.named_parameters()}
        return state, losses, step, grads

    plain, p_losses, _, g_plain = steps(held, None, case.steps)
    control, _, _, g_ctl = steps(held, None, case.steps, swap)
    meshed, m_losses, mesh_step, g_mesh = steps(held, mesh, case.steps)
    top = max(float(g.abs().max()) for g in g_plain.values())
    vanishing = {k for k, g in g_plain.items()
                 if float(g.abs().max()) <= VANISHING * top}
    bn_biases = {f"{n}.bias" for n, mod in held.named_modules()
                 if isinstance(mod, BatchNorm)}
    rec = dict(
        losses=m_losses, plain_losses=p_losses, vanishing=len(vanishing),
        # only a BatchNorm's shift can be removed downstream
        vanishing_held=vanishing <= bn_biases and all(
            float(g[k].abs().max()) <= VANISHING * top
            for g in (g_ctl, g_mesh) for k in vanishing),
        grads_err=rel_l1(g_mesh, g_plain, vanishing),
        grads_control=rel_l1(g_ctl, g_plain, vanishing),
        err=rel_l1(meshed.net, plain.net, vanishing),
        control=rel_l1(control.net, plain.net, vanishing))
    del plain, control, g_plain, g_ctl, g_mesh
    rec["step_ms"] = time_ms(lambda: mesh_step(meshed, images, labels),
                             TPSP_TIMED, warmup=1)
    rec["collectives"] = counted_collectives(
        lambda: mesh_step(meshed, images, labels))
    del meshed
    if case.witness:
        rec["kinked_plain_loss"] = steps(net0, None, 1)[1][0]
        rec["kinked_loss"] = steps(net0, mesh, 1)[1][0]
    return rec


def tpsp_fused(mesh, net0, spec, hb, bsz) -> dict:
    """One fused bf16 step at ``bsz`` with augment on: its rotation
    launches on this rank, loss and finiteness; a second step's ms."""
    import copy

    import torch

    from k210_yolo_framework_tpu_torch.config import TrainConfig
    from k210_yolo_framework_tpu_torch.data import pipeline as PL
    from k210_yolo_framework_tpu_torch.ops import rotate_pallas as TR
    from k210_yolo_framework_tpu_torch.training import train as TT

    cfg = TrainConfig(batch_size=bsz, augment=True)
    state = TT.create_train_state(copy.deepcopy(net0), cfg,
                                  torch.device("cuda", 0))
    TT.shard_state(state, mesh)
    fused = TT.make_fused_train_step(
        spec, cfg, PL.make_preprocess_fn(spec, True, torch.bfloat16),
        torch.bfloat16, mesh=mesh)
    host = PL.HostBatch(*(a[:bsz] for a in hb))
    TR.rotate_3shear.launches = 0
    state, logs = fused(state, *host, torch.Generator().manual_seed(5))
    torch.cuda.synchronize()
    launches = TR.rotate_3shear.launches
    t0 = time.perf_counter()
    fused(state, *host, torch.Generator().manual_seed(6))
    torch.cuda.synchronize()
    return dict(launches=launches, ms=(time.perf_counter() - t0) * 1e3,
                loss=float(logs["loss"]),
                finite=all(bool(torch.isfinite(v).all())
                           for v in logs.values() if torch.is_tensor(v)))


def tpsp_recalibrate(mesh, net0, spec, ann) -> dict:
    """``recalibrate_batch_stats(mesh=)`` against the single-process
    recalibration on the same TPSP_RECAL host batches: the largest
    difference of any BatchNorm statistic, the largest statistic, and
    whether every statistic is within test_torch_tpsp_tiny.py's bound
    (exact at dp = 1, where every rank takes the whole batch; else rtol
    1e-5, atol 1e-6: the moments are summed over the data axis)."""
    import copy

    import torch

    from k210_yolo_framework_tpu_torch.data import pipeline as PL
    from k210_yolo_framework_tpu_torch.models.layers import BatchNorm
    from k210_yolo_framework_tpu_torch.parallel import mesh as PM
    from k210_yolo_framework_tpu_torch.training import train as TT

    n, bsz = TPSP_RECAL
    it = iter(PL.DataPipeline(ann, bsz, seed=1))
    hosts = [next(it) for _ in range(n)]
    it.close()
    pp = PL.make_preprocess_fn(spec, False, torch.float32)
    device = torch.device("cuda", 0)
    nets = []
    for m in (None, mesh):
        net = copy.deepcopy(net0).to(device)
        TT.recalibrate_batch_stats(net, iter(hosts), pp, num_batches=n,
                                   device=device, mesh=m)
        nets.append([t for mod in net.modules() if isinstance(mod, BatchNorm)
                     for t in (mod.running_mean, mod.running_var)])
    rtol, atol = (0.0, 0.0) if PM.axis_size(mesh, PM.DATA_AXIS) == 1 \
        else (1e-5, 1e-6)
    return dict(max_diff=max(float((b - a).abs().max())
                             for a, b in zip(*nets)),
                largest=max(float(a.abs().max()) for a in nets[0]),
                tensors=len(nets[0]),
                within=all(bool(((b - a).abs() <= atol + rtol * a.abs()).all())
                           for a, b in zip(*nets)))


def tpsp_work(dims, ann) -> dict:
    """Each TPSP_CASES builder in turn on the (dp, mp, sp) mesh ``dims``:
    served (``tpsp_serve``), trained (``tpsp_train``), its fused step
    (``tpsp_fused``) and, in the 4-rank world, its recalibration on
    dp2*sp2 and tp2*sp2 (``tpsp_recalibrate``), as the case asks; then
    (phase 22) each case's quantize and stem modes served
    (``tpsp_serve`` with a ``TPSP_QUANTIZED`` name); the wall seconds of
    each."""
    import torch

    from k210_yolo_framework_tpu_torch.data import pipeline as PL
    from k210_yolo_framework_tpu_torch.models import build_network
    from k210_yolo_framework_tpu_torch.parallel import make_mesh

    device = torch.device("cuda", 0)
    mesh = make_mesh(*dims, device_type="cuda")
    canvases, hws, _ = scene_inputs()
    c_dev = torch.from_numpy(canvases).to(device)
    h_dev = torch.from_numpy(hws).to(device)
    it = iter(PL.DataPipeline(ann, BATCH, seed=0))
    hb = next(it)
    it.close()
    seen = {}
    for case in TPSP_CASES:
        t0 = time.perf_counter()
        spec = builder_spec(case.layers, case.in_hw)
        net0 = build_network(case.model, spec.in_hw, spec.nanchors,
                             spec.class_num, alpha=case.alpha,
                             generator=torch.Generator().manual_seed(0))
        rec = {"serve": {label: tpsp_serve(mesh, net0, spec, label, bsz,
                                           c_dev, h_dev)
                         for label, bsz in case.serve}}
        if case.train_b:
            rec["train"] = tpsp_train(mesh, net0, spec, hb, case)
        if case.fused_b:
            rec["fused"] = tpsp_fused(mesh, net0, spec, hb, case.fused_b)
        if case.recalibrate and dims[0] * dims[1] * dims[2] == 4:
            rec["recalibrate"] = {
                tpsp_name(d): tpsp_recalibrate(
                    make_mesh(*d, device_type="cuda"), net0, spec, ann)
                for d in ((2, 1, 2), (1, 2, 2))}
        rec["wall_s"] = time.perf_counter() - t0
        seen[case.tag] = rec
        del net0
        torch.cuda.empty_cache()
    for case in TPSP_CASES:       # phase 22, after every phase 20-21 case
        if not case.quantized:
            continue
        t0 = time.perf_counter()
        spec = builder_spec(case.layers, case.in_hw)
        net0 = build_network(case.model, spec.in_hw, spec.nanchors,
                             spec.class_num, alpha=case.alpha,
                             generator=torch.Generator().manual_seed(0))
        rec = seen[case.tag]
        rec["quantized"] = {
            cfg: tpsp_serve(mesh, net0, spec, "fp32", bsz, c_dev, h_dev, cfg,
                            (canvases[:bsz], hws[:bsz]))
            for cfg, bsz in case.quantized}
        rec["quantized_wall_s"] = time.perf_counter() - t0
        del net0
        torch.cuda.empty_cache()
    seen["memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return seen


def tpsp_checks(seen) -> dict:
    """The checks of one rank's record, by name: serving at set level
    (fp32: test_sharded_serving.py's bounds, at most 0.5% unmatched either
    way, matched scores within 1e-3; bf16: at most 1% and 0.02, bf16
    rounding of a reordered sum flips a borderline box) with one head
    launch a call, on the global path past 11,622 candidates; training by
    test_parallel_equivalence.py's rule (step-1 loss rtol 1e-5, first-step
    gradients and final parameters within 10x the control, the leaves at
    rounding level kept there) and the net's own step-1 loss rtol 1e-5;
    one rotation launch a fused step; the recalibration within its
    bound; phase 22's quantized and patches serving (the int8-activation
    modes within TPSP_ACT_BOUND, the others at the fp32 bounds), one head
    launch a call, the int8 weight bytes the single-process Predictor's,
    no range all-reduce where no range is reduced."""
    checks = {}
    for case in TPSP_CASES:
        t, rec = case.tag, seen[case.tag]
        for cfg, q in rec.get("quantized", {}).items():
            act = TPSP_QUANTIZED[cfg][0] in ("int8_act", "int8_act_sym",
                                             "int8_act_cal")
            share, diff = TPSP_ACT_BOUND if act else (0.005, 1e-3)
            checks[f"{t} {cfg} serving at set level"] = within_share(
                *q["stats"][:4], share) and q["stats"][4] <= diff
            checks[f"{t} {cfg} one head launch a call"] = q["launches"] == 1
            checks[f"{t} {cfg} weights held whole"] = \
                q["bytes"][0] == q["bytes"][1]
            if TPSP_QUANTIZED[cfg][0] not in ("int8_act", "int8_act_sym"):
                checks[f"{t} {cfg} no range all-reduce"] = \
                    q["all_reduces"] == 0
        for label, s in rec["serve"].items():
            share, diff = (0.005, 1e-3) if label == "fp32" else (0.01, 0.02)
            checks[f"{t} {label} serving at set level"] = within_share(
                *s["stats"][:4], share) and s["stats"][4] <= diff
            checks[f"{t} {label} one head launch a call"] = s["launches"] == 1
            if s["n"] > 11622:
                checks[f"{t} {label} the head on its global path"] = \
                    s["global_launches"] == 1
        tr = rec.get("train")
        if tr is not None:
            checks[f"{t} step-1 loss rtol 1e-5"] = abs(
                tr["losses"][0] - tr["plain_losses"][0]) \
                <= 1e-5 * abs(tr["plain_losses"][0])
            if case.witness:
                checks[f"{t} the net's step-1 loss rtol 1e-5"] = abs(
                    tr["kinked_loss"] - tr["kinked_plain_loss"]) \
                    <= 1e-5 * abs(tr["kinked_plain_loss"])
            checks[f"{t} gradients within 10x the control"] = \
                tr["grads_err"] < 10 * max(tr["grads_control"], 1e-6)
            checks[f"{t} parameters within 10x the control"] = \
                tr["err"] < 10 * max(tr["control"], 1e-6)
            checks[f"{t} gradients at rounding level stay there"] = \
                tr["vanishing_held"]
        fu = rec.get("fused")
        if fu is not None:
            checks[f"{t} one rotation launch"] = fu["launches"] == 1
            checks[f"{t} finite fused step"] = fu["finite"]
        for name, rc in rec.get("recalibrate", {}).items():
            checks[f"{t} recalibration on {name} equal to one process"] = \
                rc["within"]
    return checks


def tpsp_lines(name, world, r, case, rec, tag):
    """The lines printed for ``case`` on rank ``r``: results, then times,
    for phases 20-21 and, where the case has any, phase 22."""
    parts, times = [], []
    for label, s in rec["serve"].items():
        un_ab, n_a, un_ba, n_b, ds = s["stats"]
        bsz = dict(case.serve)[label]
        parts.append(f"serve {label} b{bsz} N={s['n']} unmatched "
                     f"{un_ab}/{n_a} and {un_ba}/{n_b} (flip rate "
                     f"{(un_ab + un_ba) / max(n_a + n_b, 1):.4f}), matched "
                     f"score diff {ds:.3g}, valid equal {s['valid_equal']}, "
                     f"head launches {s['launches']} "
                     f"({s['global_launches']} global)")
        times.append(f"serve {label} b{bsz} {s['ms']:.1f} ms")
    tr = rec.get("train")
    if tr is not None:
        what = "smooth witness" if case.witness else "train"
        parts.append(
            f"{what} fp32 b{case.train_b} losses {tr['losses']} vs plain "
            f"{tr['plain_losses']}, params rel_l1 {tr['err']:.3g} vs control "
            f"{tr['control']:.3g}, step-1 grads rel_l1 {tr['grads_err']:.3g} "
            f"vs control {tr['grads_control']:.3g} ({tr['vanishing']} "
            f"leaves at rounding level, left out); collectives a step "
            f"{tr['collectives']}")
        if case.witness:
            parts.append(f"the net's step-1 loss {tr['kinked_loss']:.6f} vs "
                         f"plain {tr['kinked_plain_loss']:.6f}")
        times.append(f"train step fp32 b{case.train_b} {tr['step_ms']:.1f} ms")
    fu = rec.get("fused")
    if fu is not None:
        parts.append(f"fused bf16 b{case.fused_b} loss {fu['loss']:.4f}, "
                     f"rotate launches {fu['launches']}")
        times.append(f"fused step bf16 b{case.fused_b} (second call) "
                     f"{fu['ms']:.1f} ms")
    for mesh_name, rc in rec.get("recalibrate", {}).items():
        parts.append(f"recalibrate_batch_stats(mesh={mesh_name}) against one "
                     f"process: max diff {rc['max_diff']:.3g} over "
                     f"{rc['tensors']} statistics (largest "
                     f"{rc['largest']:.3g})")
    head = f"tp/sp {name} rank {r} {case.tag} (phase {case.phase})"
    lines = [f"{head}: {'; '.join(parts)}",
             f"{head} (gloo on one card, {world} processes sharing it: not "
             f"a scaling number): {', '.join(times)}; wall "
             f"{rec['wall_s']:.1f} s {tag}"]
    q_parts, q_times = [], []
    for (cfg, bsz), q in zip(case.quantized,
                             rec.get("quantized", {}).values()):
        un_ab, n_a, un_ba, n_b, ds = q["stats"]
        q_parts.append(f"{cfg} fp32 b{bsz} unmatched {un_ab}/{n_a} and "
                       f"{un_ba}/{n_b}, matched score diff {ds:.3g}, head "
                       f"launches {q['launches']}, range all-reduces "
                       f"{q['all_reduces']}, weight bytes {q['bytes'][1]} "
                       f"(one process {q['bytes'][0]})")
        q_times.append(f"{cfg} b{bsz} {q['ms']:.1f} ms")
    if q_parts:
        head = f"tp/sp {name} rank {r} {case.tag} (phase 22)"
        lines += [f"{head}: {'; '.join(q_parts)}",
                  f"{head} (gloo on one card, {world} processes sharing it: "
                  f"not a scaling number): {', '.join(q_times)}; wall "
                  f"{rec['quantized_wall_s']:.1f} s {tag}"]
    return lines


def tpsp_phase(tag, ann):
    """Phases 20-22: the model and space axes on one card.  Each world of
    ``TPSP_WORLDS`` (2 or 4 processes, gloo over CUDA tensors) is spawned
    once and runs every TPSP_CASES builder (``tpsp_work``), held by
    ``tpsp_checks``; then the refusal of ``keras_train --mesh 1,2`` on a
    one-card CUDA machine.  Returns (head launches, of them on the global
    path, rotation launches)."""
    import pickle

    import torch

    from k210_yolo_framework_tpu_torch.cli import keras_train as KT
    from k210_yolo_framework_tpu_torch.parallel import spawn_ranks

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    head = head_global = rot = 0
    for dims in TPSP_WORLDS:
        world = dims[0] * dims[1] * dims[2]
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            spawn_ranks(tpsp_rank, world,
                        (world, f"{tmp}/init", dims, ann, tmp))
            ranks = [pickle.loads(Path(tmp, f"rank{r}.pkl").read_bytes())
                     for r in range(world)]
        name = tpsp_name(dims)
        for r, seen in enumerate(ranks):
            for case in TPSP_CASES:
                rec = seen[case.tag]
                served = [*rec["serve"].values(),
                          *rec.get("quantized", {}).values()]
                head += sum(s["launches"] for s in served)
                head_global += sum(s["global_launches"] for s in served)
                rot += rec.get("fused", {}).get("launches", 0)
                print(*tpsp_lines(name, world, r, case, rec, tag), sep="\n")
            print(f"tp/sp {name} rank {r}: peak {seen['memory_gib']:.1f} GiB")
            failed = [k for k, ok in tpsp_checks(seen).items() if not ok]
            if failed:
                raise AssertionError(f"tp/sp {name} rank {r}: {failed}")
        print(f"tp/sp {name}: {world} ranks, wall "
              f"{time.perf_counter() - t0:.1f} s")

    # --mesh 1,2 on a one-card CUDA machine: one card a rank, no fallback
    try:
        KT.main(KT.parse_args(CLI_NET + ["--mesh", "1,2"]))
    except SystemExit as e:
        refusal = str(e)
    else:
        refusal = ""
    print(f"tp/sp: keras_train --mesh 1,2 on {torch.cuda.device_count()} "
          f"card(s): {refusal!r}")
    if torch.cuda.device_count() == 1 and "one a card" not in refusal:
        raise AssertionError("keras_train --mesh 1,2 did not refuse one card")
    print(f"phases 20-22: wall seconds {time.perf_counter() - t_phase:.1f}")
    return head, head_global, rot


# ---- 23. the benchmark program and the entry contracts -----------------------
# every mode of ``python -m k210_yolo_framework_tpu_torch.bench`` once: "all"
# (7 lines) and the five modes "all" leaves out, in process at the module's
# settings
BENCH_RUNS = ("all", "serve_dual", "serve_dense", "serve_int8act",
              "serve_int8act_sym", "serve_int8act_cal")
BENCH_ALL = ("e2e_infer_imgs_per_sec_per_chip",
             "e2e_infer_512canvas_imgs_per_sec_per_chip",
             "e2e_infer_int8w_imgs_per_sec_per_chip",
             "device_roofline_infer_imgs_per_sec_per_chip",
             "loader_e2e_imgs_per_sec_per_chip",
             "train_imgs_per_sec_per_chip",
             "train_e2e_imgs_per_sec_per_chip")
ENTRY_TOL = dict(rtol=1e-5, atol=1e-5)   # test_forward_matches_jax_fp32's


def bench_lines(argv) -> list:
    """``bench.main(argv)`` in this process: the JSON lines it printed,
    each parsed, beside what it returned."""
    import contextlib
    import io

    from k210_yolo_framework_tpu_torch import bench

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        lines = bench.main(argv)
    printed = [json.loads(line) for line in out.getvalue().splitlines()
               if line.startswith("{")]
    if printed != lines:
        raise AssertionError(f"bench {argv}: printed {printed}, returned "
                             f"{lines}")
    return printed


def bench_entry_phase(device, tag, serve_ips, step_ms, fused_ms):
    """Phase 23: every bench mode (``BENCH_RUNS``) on the card, each line
    parsed, its keys checked and printed; ``serve`` beside phase 5's imgs/s
    and ``train`` / ``train_e2e`` beside phase 9's step and fused step;
    ``entry()`` on the card against the same forward on the CPU (zeros,
    the contract's input, and uniform images; fp32, ENTRY_TOL); and
    ``dryrun_multichip`` on the card: 8 ranks (gloo processes sharing the
    one card) and 1 (NCCL).  Returns the head and rotation kernels'
    launches that ran eagerly (the ``serve_scan`` graph's are printed
    apart)."""
    import contextlib
    import io

    import torch

    from k210_yolo_framework_tpu_torch import bench
    from k210_yolo_framework_tpu_torch import entry as TE
    from k210_yolo_framework_tpu_torch.ops import rotate_pallas as TR
    from k210_yolo_framework_tpu_torch.ops import yolo_head_pallas as TH

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    name = torch.cuda.get_device_name(0)
    TH.fused_decode_nms.launches = 0
    TR.rotate_3shear.launches = 0
    lines = {}
    for mode in BENCH_RUNS:
        t0 = time.perf_counter()
        got = bench_lines(["--mode", mode])
        metrics = [line["metric"] for line in got]
        if len(got) != (len(BENCH_ALL) if mode == "all" else 1) or (
                mode == "all" and metrics != list(BENCH_ALL)):
            raise AssertionError(f"bench --mode {mode}: {metrics}")
        for line in got:
            dev = line["device"]
            if dev["name"] != name \
                    or dev["count"] != torch.cuda.device_count() \
                    or not (dev["power_limit_w"] or 0) > 0 \
                    or not np.isfinite(line["value"]) or line["value"] <= 0:
                raise AssertionError(f"bench --mode {mode}: {line}")
            lines[line["metric"]] = line
            print(f"bench {mode}: {json.dumps(line)}")
        print(f"bench {mode}: wall seconds {time.perf_counter() - t0:.1f}")
    head, rot = TH.fused_decode_nms.launches, TR.rotate_3shear.launches
    scan = lines["device_roofline_infer_imgs_per_sec_per_chip"]
    print(f"bench: head kernel launches {head} eager (the serve_scan "
          f"graph's {scan['graph_replays']} replays launched it "
          f"{scan['graph_replays'] * scan['scan_k']} times more, outside the "
          f"wrapper's count), rotation kernel launches {rot}")
    # train_e2e: one launch a step, its warm-up and its timed steps
    if head == 0 or rot != 1 + bench.ROUNDS * bench.TRAIN_ITERS:
        raise AssertionError(f"bench: head {head}, rotation {rot} launches")
    dense = lines["e2e_infer_dense_scene_imgs_per_sec_per_chip"]
    if not scan["cuda_graph"] or scan["graph_replays"] \
            != 1 + bench.ROUNDS * bench.SCAN_ITERS \
            or not dense.get("dense_scene"):
        raise AssertionError(f"bench: serve_scan {scan}, dense {dense}")
    serve = lines["e2e_infer_imgs_per_sec_per_chip"]
    train = lines["train_imgs_per_sec_per_chip"]
    e2e = lines["train_e2e_imgs_per_sec_per_chip"]
    print(f"bench serve {serve['value']} imgs/s beside phase 5's "
          f"{serve_ips:.1f} ({serve['value'] / serve_ips:.3f}x); "
          f"serve_scan {scan['value']} ({scan['value'] / serve['value']:.3f}x "
          f"serve); all rounds {serve['window_value']} / "
          f"{scan['window_value']}; b128 device {serve['batch_device_ms']} "
          f"ms, b1 {serve['single_frame_device_ms']} ms by events {tag}")
    print(f"bench train {train['ms_per_step']} ms a step beside phase 9's "
          f"step {step_ms:.3f} ms ({train['ms_per_step'] / step_ms:.3f}x), "
          f"{train['model_tflops_per_sec']} TFLOP/s of convs, MFU "
          f"{train['mfu_vs_h100_989tflops']}; train_e2e "
          f"{e2e['ms_per_step']} ms beside phase 9's fused step "
          f"{fused_ms:.3f} ms ({e2e['ms_per_step'] / fused_ms:.3f}x) {tag}")

    # entry(): the forward on the card against the same one on the CPU
    forward, (net, images) = TE.entry()
    cpu_forward, (cpu_net, cpu_images) = TE.entry("cpu")
    noise = np.random.default_rng(7).uniform(
        0, 1, tuple(images.shape)).astype(np.float32)
    worst = 0.0
    for x, x_cpu in ((images, cpu_images),
                     (torch.from_numpy(noise).to(device),
                      torch.from_numpy(noise))):
        with torch.no_grad():
            got = [t.cpu() for t in forward(net, x)]
            want = cpu_forward(cpu_net, x_cpu)
        for g, w in zip(got, want, strict=True):
            worst = max(worst, float((g - w).abs().max()))
            if not torch.allclose(g, w, **ENTRY_TOL):
                raise AssertionError(f"entry(): card against CPU, max abs "
                                     f"{float((g - w).abs().max()):.3g}")
    print(f"entry(): {len(got)} head outputs {[tuple(t.shape) for t in got]}"
          f", card against CPU max abs {worst:.3g} (fp32, zeros and uniform "
          f"images) {tag}")
    # the virtual mesh (8 ranks, gloo over CUDA tensors, sharing the card)
    # and the NCCL world (one rank a card)
    cards = torch.cuda.device_count()
    for n, on in ((8, f"8 gloo processes sharing {cards} {name}"),
                  (1, f"1 NCCL ranks on {name}")):
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            TE.dryrun_multichip(n)
        said = out.getvalue().strip()
        print(f"{said}; wall seconds {time.perf_counter() - t0:.1f}")
        if not said.startswith(f"dryrun_multichip({n}) OK") \
                or not said.endswith(on):
            raise AssertionError(f"dryrun_multichip({n}): {said!r}")
    print(f"phase 23: wall seconds {time.perf_counter() - t_phase:.1f}")
    return head, rot


# ---- 24. the conv epilogue ------------------------------------------------
# (builder, alpha, input, batch, canvas, ConvBNs, of them Mish): the served
# shapes of the benchmark's three serving cells
EPILOGUE_NETS = (("yolo_mobilev1", 0.75, (224, 320), BATCH, CANVAS_HW, 30,
                  0),
                 ("yolo", 1.0, (BIG_SIDE, BIG_SIDE), EVAL_BATCH, (512, 512),
                  72, 0),
                 ("yolov4", 1.0, (BIG_SIDE, BIG_SIDE), EVAL_BATCH,
                  (512, 512), 107, 72))
# the Mish kernel against F.mish (tests/test_torch_cuda_yolov4.py): within
# 8 fp32 ulps of the operands' magnitude, plus one bf16 ulp of the value
# for a bf16 store, and a bf16 store differing in under 1% of its values
MISH_FP32_ULPS = 8
MISH_BF16_DIFFER_SHARE = 0.01
# the head's eval settings (keras_eval): obj 0.01, NMS 0.45, 100 a class
EVAL_THRESH, EVAL_IOU, EVAL_MAX_OUT = 0.01, 0.45, 100


def bits(t):
    """``t``'s bits as integers: NaN payloads, -0 and inf compare exactly."""
    import torch

    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def drawn_bn(net, seed: int):
    """Draw every BatchNorm's statistics and affine terms, so that no BN is
    the identity."""
    import torch

    from k210_yolo_framework_tpu_torch.models.layers import BatchNorm

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(0.0, 0.3, generator=g)
                m.running_var.uniform_(0.3, 2.0, generator=g)
                m.weight.uniform_(0.4, 0.6, generator=g)
                m.bias.normal_(0.3, 0.3, generator=g)
    return net


def recorded_epilogues(pred, canvases, hws):
    """``pred.predict_batch(canvases, hws)`` with the launch count zeroed
    just before it: (the launches it made, each ConvBN epilogue call of it
    as (keyword arguments, a copy of the kernel's output))."""
    import torch

    from k210_yolo_framework_tpu_torch.models import layers as L
    from k210_yolo_framework_tpu_torch.ops import conv_epilogue as TE

    calls, real = [], L.conv_epilogue

    def record(x, mean, mul, bias, act, alpha, scale=None, residual=None,
               store=torch.float32):
        kw = dict(x=x, mean=mean, mul=mul, bias=bias, act=act, alpha=alpha,
                  scale=scale, residual=residual, store=store)
        out = real(**kw)
        calls.append((kw, out.clone()))
        return out

    L.conv_epilogue = record
    try:
        TE.conv_epilogue.launches = 0
        pred.predict_batch(canvases, hws)
        torch.cuda.synchronize()
        launches = TE.conv_epilogue.launches
    finally:
        L.conv_epilogue = real
    return launches, calls


EPILOGUE_KERNELS = ("epilogue_kernel", "epilogue_mish_kernel")


def is_epilogue_kernel(name: str) -> bool:
    return any(k in name for k in EPILOGUE_KERNELS)


def mish_outside(kw, got, want) -> tuple:
    """A Mish call's kernel output ``got`` against its plain version
    ``want``: (values outside MISH_FP32_ULPS's tolerance or NaN where the
    other is not, the largest difference, the share of values that
    differ)."""
    import torch

    from k210_yolo_framework_tpu_torch.ops import conv_epilogue as TE

    core = TE.conv_epilogue_reference(**{**kw, "residual": None,
                                         "store": torch.float32}).abs()
    size = core if kw["residual"] is None else core + kw["residual"].abs()
    tol = MISH_FP32_ULPS * torch.finfo(torch.float32).eps * size + 1e-37
    if kw["store"] == torch.bfloat16:
        tol = tol + torch.finfo(torch.bfloat16).eps * want.float().abs()
    ok = ~want.isnan()
    # equal infinities differ by NaN: count them as equal
    err = torch.where(got == want, 0.0, (got.float() - want.float()).abs())
    outside = int((got.isnan() != want.isnan()).sum()) \
        + int((err[ok] > tol[ok]).sum())
    return (outside, float(err[ok].max()),
            float((got != want)[ok].float().mean()))


def epilogue_profile(fn) -> tuple:
    """One ``fn()`` under torch.profiler: (``k210::conv_epilogue`` host
    ops, those holding an epilogue kernel, epilogue kernels on the card,
    their device ms, of those kernels the Mish ones)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    ops = [e for e in events if e.name == "k210::conv_epilogue"]
    held = sum(any(is_epilogue_kernel(k.name) for k in e.kernels)
               for e in ops)
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and is_epilogue_kernel(e.name)]
    return (len(ops), held, len(dev),
            sum(e.time_range.elapsed_us() for e in dev) / 1e3,
            sum("epilogue_mish_kernel" in e.name for e in dev))


def epilogue_host_us(device, n: int = 2000) -> tuple:
    """Host microseconds a call of the wrapper and of its plain version on
    a [1, 64, 8, 8] bf16 tensor the card finishes at once, no profiler
    running."""
    import torch

    from k210_yolo_framework_tpu_torch.ops import conv_epilogue as TE

    x = torch.randn((1, 64, 8, 8), device=device).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    terms = [torch.rand(64, device=device) for _ in range(3)]
    out = []
    for fn in (TE.conv_epilogue, TE.conv_epilogue_reference):
        with torch.inference_mode():
            for _ in range(50):
                fn(x, *terms, "leaky_relu", 0.3, store=torch.bfloat16)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn(x, *terms, "leaky_relu", 0.3, store=torch.bfloat16)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
        out.append((t1 - t0) / n * 1e6)
    return tuple(out)


def v4_head_phase(pred, c_dev, h_dev, device, tag) -> dict:
    """YOLOv4's head at 608x608 with ``scale_x_y`` on the served net's own
    logits, at the eval settings: the kernel (global path) against its
    plain version ``_decode_and_select``, bit for bit, and timed by
    ``time_head``; the same logits decoded with s = 1 give other boxes.
    Returns the head's JSON fields."""
    import dataclasses

    import torch

    from k210_yolo_framework_tpu_torch.ops import yolo_head_pallas as TH
    from k210_yolo_framework_tpu_torch.ops.nms import finish_winners

    spec = pred.spec
    if not spec.scale_x_y or spec.scale_x_y != tuple(pred.net.scale_x_y):
        raise AssertionError(f"the Predictor's spec has scale_x_y "
                             f"{spec.scale_x_y}, not the net's")
    logits = pred._forward_batch(c_dev, h_dev)
    bsz = logits[0].shape[0]
    kw = dict(classes=spec.class_num, max_out=EVAL_MAX_OUT,
              iou_thresh=EVAL_IOU)
    lbox = TH.letterbox_inverse_params(h_dev, spec.in_hw).contiguous()
    p = TH._flatten_preds(logits, spec.class_num)
    n = p.shape[1]

    def winners(s, plain):
        geom = TH._geometry_on(s, device)
        if plain:
            w_s, *w_box = TH._decode_and_select(
                p, geom, lbox, class_softmax=False, stop_below=EVAL_THRESH,
                **kw)
            return finish_winners(w_s, torch.stack(w_box, dim=-1),
                                  EVAL_THRESH)
        return finish_winners(*TH._launch(
            p, geom, lbox, score_thresh=EVAL_THRESH, class_softmax=False,
            **kw), EVAL_THRESH)

    layout = TH._plan(device, bsz, n, spec.class_num)[0]
    geom = TH._geometry_on(spec, device)
    got, want = winners(spec, False), winners(spec, True)
    differ = sum(int((g != w).sum()) for g, w in zip(got, want))
    one = winners(dataclasses.replace(spec, scale_x_y=()), False)
    moved = not torch.equal(one.boxes, got.boxes)
    kept = int(got.valid.sum())
    print(f"head yolov4 {spec.in_hw[0]}x{spec.in_hw[1]} b{bsz} (N={n}, "
          f"{layout} layout, geometry rows 6-7 "
          f"{sorted({round(float(v), 4) for v in geom[6]})} / "
          f"{sorted({round(float(v), 4) for v in geom[7]})}), eval "
          f"settings: kernel vs plain elements_differing={differ}, kept "
          f"{kept}; the same logits at s = 1 move the boxes: {moved} {tag}")
    if layout != "global" or differ or not kept or not moved:
        raise AssertionError(f"head yolov4: {layout} layout, {differ} "
                             f"differ, {kept} kept, s = 1 moves: {moved}")
    k_ms, p_ms, b_ms, by, dev_k = time_head(
        "yolov4 eval", spec, logits, h_dev, EVAL_THRESH, EVAL_MAX_OUT,
        EVAL_IOU, device, tag, plain_iters=2, kern_iters=5)
    return dict(n=n, batch=bsz, layout=layout, elements_differing=differ,
                kept=kept, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=by, device_ms=dev_k)


def epilogue_phase(device, tag) -> dict:
    """Phase 24: the conv epilogue on the served nets, yolo_mobilev1 (alpha
    0.75) at 224x320, B=128, and the darknet53 yolo and YOLOv4 at 608x608,
    B=32, bf16, seeded, every BatchNorm drawn.  Each is served once through
    ``predict_batch``: one launch per ConvBN (YOLOv4: 107, 72 of them
    Mish), every leaky, ReLU and linear call's output bit for bit its
    plain version's on the same arguments, and every Mish call's within
    MISH_FP32_ULPS of it.  Then the times over all of a forward's calls
    (plain, kernel, kernel, plain), against the bytes bound (x read once
    in its dtype, the residual once in fp32, the output written once in
    its store dtype); whether the profiler ties each kernel to its
    ``k210::conv_epilogue`` op; and the wrapper's host cost a call.
    YOLOv4's head is held to its plain version with ``scale_x_y``
    (:func:`v4_head_phase`).  Returns the kernel's JSON fields
    (yolo_mobilev1's at the top, yolo's under ``yolo608``, YOLOv4's under
    ``yolov4``)."""
    import torch

    from k210_yolo_framework_tpu_torch.inference import Predictor
    from k210_yolo_framework_tpu_torch.models import build_network
    from k210_yolo_framework_tpu_torch.ops import conv_epilogue as TE

    fields, launches = {}, 0
    for name, alpha, in_hw, bsz, canvas, n_convbn, n_mish in EPILOGUE_NETS:
        spec = builder_spec(2 if name == "yolo_mobilev1" else 3, in_hw)
        net = drawn_bn(build_network(
            name, in_hw, spec.nanchors, spec.class_num, alpha=alpha,
            generator=torch.Generator().manual_seed(0)), seed=1)
        pred = Predictor(net, None, spec, obj_thresh=0.7, iou_thresh=IOU,
                         compute_dtype=torch.bfloat16, device=device)
        rng = np.random.default_rng(5)
        canvases = rng.integers(0, 256, (bsz, *canvas, 3)).astype(np.uint8)
        hws = np.tile(np.asarray(canvas, np.int32), (bsz, 1))
        hws[bsz // 2:] = [canvas[0] * 3 // 4, canvas[1]]
        with torch.inference_mode():
            n, calls = recorded_epilogues(pred, canvases, hws)
            launches += n
            differ, mish, outside, mish_err, mish_share = 0, 0, 0, 0.0, 0.0
            for kw, got in calls:
                want = TE.conv_epilogue_reference(**kw)
                if got.dtype != want.dtype:
                    differ += 1
                elif kw["act"] == "mish":
                    mish += 1
                    out_k, err_k, share_k = mish_outside(kw, got, want)
                    outside += out_k
                    mish_err = max(mish_err, err_k)
                    if kw["store"] == torch.bfloat16:
                        mish_share = max(mish_share, share_k)
                else:
                    differ += not torch.equal(bits(got), bits(want))
                del want
            print(f"epilogue {name} {in_hw[0]}x{in_hw[1]} b{bsz} bf16: "
                  f"{n} launches in one predict_batch, {len(calls)} ConvBN "
                  f"calls, {differ} of the {len(calls) - mish} others "
                  f"differing from the plain version (bit for bit); {mish} "
                  f"Mish calls: {outside} values outside "
                  f"{MISH_FP32_ULPS} fp32 ulps, max_abs_err {mish_err:.3g}, "
                  f"bf16 stores differing in at most "
                  f"{100 * mish_share:.3f}% of their values")
            if n != n_convbn or len(calls) != n_convbn or differ \
                    or mish != n_mish or outside \
                    or mish_share >= MISH_BF16_DIFFER_SHARE:
                raise AssertionError(f"epilogue {name}: {n} launches, "
                                     f"{len(calls)} calls, {differ} differ, "
                                     f"{mish} Mish, {outside} outside, "
                                     f"{mish_share} bf16 share")
            args = [kw for kw, _ in calls]
            del calls
            k_ms, p_ms, (p1, k1, k2, p2) = alternating(
                lambda: [TE.conv_epilogue_reference(**kw) for kw in args],
                lambda: [TE.conv_epilogue(**kw) for kw in args], 3, 10)
            c_dev = torch.from_numpy(canvases).to(device)
            h_dev = torch.from_numpy(hws).to(device)
            ops, held, kernels, dev_ms, mish_k = epilogue_profile(
                lambda: pred._forward_batch(c_dev, h_dev))
            head = (v4_head_phase(pred, c_dev, h_dev, device, tag)
                    if name == "yolov4" else None)
        nbytes = sum(kw["x"].numel() * (
            kw["x"].element_size() + kw["store"].itemsize
            + (4 if kw["residual"] is not None else 0)) for kw in args)
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"epilogue {name} b{bsz}: {len(args)} calls, "
              f"{sum(kw['x'].numel() for kw in args)} elements, "
              f"{nbytes / 1e9:.3f} GB: kernel {k1:.4f}/{k2:.4f} ms, plain "
              f"{p1:.4f}/{p2:.4f} ms, bound {b_ms:.4f} ms (bytes; "
              f"{100 * b_ms / k_ms:.1f}% of it); profiler: {held} of {ops} "
              f"k210::conv_epilogue ops hold their kernel, {kernels} "
              f"kernels ({mish_k} epilogue_mish_kernel), {dev_ms:.4f} ms "
              f"{tag}")
        if ops != n_convbn or held != n_convbn or kernels != n_convbn \
                or mish_k != n_mish:
            raise AssertionError(f"epilogue {name}: the profiler tied "
                                 f"{held} of {ops} ops to {kernels} kernels, "
                                 f"{mish_k} of them Mish")
        fields[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                            bound_by="bytes", profiled_ms=dev_ms,
                            calls=n_convbn)
        if n_mish:
            fields[name].update(mish_calls=n_mish, mish_max_abs_err=mish_err,
                                mish_bf16_differ_share=mish_share)
        if head is not None:
            fields[name]["head"] = head
        del pred, net, args, c_dev, h_dev
        torch.cuda.empty_cache()
    wrap_us, plain_us = epilogue_host_us(device)
    print(f"epilogue host cost a call, no profiler: wrapper {wrap_us:.1f} us, "
          f"plain version {plain_us:.1f} us {tag}")
    return {"launches": launches, "max_abs_err": 0.0,
            **fields["yolo_mobilev1"], "library_ms": None,
            "host_us": wrap_us, "yolo608": fields["yolo"],
            "yolov4": fields["yolov4"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1
    return run(torch.device("cuda"))


def three_scale_spec():
    """The 20-class spec with a third scale (4,410 candidates)."""
    from k210_yolo_framework_tpu_torch import YoloSpec

    rng = np.random.default_rng(1)
    anchors3 = np.sort(rng.uniform(0.05, 0.9, (3, 3, 2)))[:, ::-1]
    return YoloSpec.create((224, 320), ((7, 10), (14, 20), (28, 40)), 20,
                           anchors3)


def serving_scenes(spec, device):
    """The served net (yolo_mobilev1 alpha 0.75, seeded weights), its three
    bf16 Predictors as ((name, Predictor), ...): sparse (obj_thresh 0.7),
    mid (MID_THRESH) and dense (head biases +3, 0.7); and the inputs: BATCH
    canvases (half of them cut), their sizes and one 375x500 image."""
    import torch

    from k210_yolo_framework_tpu_torch.inference import Predictor
    from k210_yolo_framework_tpu_torch.models import build_network

    net = build_network("yolo_mobilev1", spec.in_hw, spec.nanchors,
                        spec.class_num, alpha=0.75,
                        generator=torch.Generator().manual_seed(0))
    serve = dict(iou_thresh=IOU, compute_dtype=torch.bfloat16, device=device)
    pred = Predictor(net, None, spec, obj_thresh=0.7, **serve)
    mid_pred = Predictor(net, None, spec, obj_thresh=MID_THRESH, **serve)
    dense_pred = Predictor(net, dense_state(net, spec), spec, obj_thresh=0.7,
                           **serve)
    scenes = (("sparse", pred), ("mid", mid_pred), ("dense", dense_pred))
    return (net, scenes, *scene_inputs())


def scene_inputs():
    """The serving scenes' inputs: BATCH canvases (half of them cut), their
    sizes and one 375x500 image, from seed 2."""
    rng = np.random.default_rng(2)
    hws = np.tile(np.asarray(CANVAS_HW, np.int32), (BATCH, 1))
    hws[BATCH // 2:] = np.stack([rng.integers(60, CANVAS_HW[0] + 1, BATCH // 2),
                                 rng.integers(60, CANVAS_HW[1] + 1, BATCH // 2)],
                                -1)
    canvases = np.zeros((BATCH, *CANVAS_HW, 3), np.uint8)
    for b, (h, w) in enumerate(hws):
        canvases[b, :h, :w] = rng.integers(0, 256, (h, w, 3))
    image = rng.integers(0, 256, (375, 500, 3)).astype(np.uint8)
    return canvases, hws, image


def run(device) -> int:
    import torch

    from k210_yolo_framework_tpu_torch import voc_spec
    from k210_yolo_framework_tpu_torch.data.pipeline import synthetic_ann_list
    from k210_yolo_framework_tpu_torch.inference import (
        Predictor,
        stack_detections,
    )
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
    names = ("yolo_head", "rotate3shear", "nms", "dwsep", "conv_epilogue")
    with ThreadPoolExecutor(len(names)) as pool:   # one nvcc each, together
        built = dict(zip(names, pool.map(_build.build, names)))
    print(f"build: {len(built)} kernels in {time.perf_counter() - t0:.2f} s")
    for name, (lib_path, log) in built.items():
        print(f"  {name}: {lib_path.name}")
        for line in log.splitlines():
            if any(k in line for k in ("entry function", "registers", "smem",
                                       "spill")):
                print(f"    ptxas: {line.strip()}")
    hmma = sass_hmma_count(built["dwsep"][0], "dwsep_mma_kernel")
    print(f"dwsep bf16 kernel (dwsep_mma_kernel: 64-pixel tile, 4 warps): "
          f"{hmma} HMMA instructions in its SASS")
    if hmma == 0:
        raise AssertionError("the bf16 dwsep kernel has no tensor-core "
                             "instruction")

    # ---- 3. kernel against its plain version ---------------------------
    spec, spec3 = voc_spec(), three_scale_spec()
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
    net, scenes, canvases, hws, image = serving_scenes(spec, device)
    pred, mid_pred, dense_pred = (p for _, p in scenes)

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
    slice_err, scene_preds = 0.0, {}
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
        scene_preds[name] = inputs[0][0]
    slice_preds = scene_preds["sparse"]

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

    cases = {name: (s, preds, hws_, 0.7, 30, IOU)
             for name, s, preds, hws_ in head_cases(spec, spec3, device)}
    cases["slice"] = (spec, slice_preds, h_dev, 0.7, 30, IOU)
    # the eval settings on the served net's logits: every row runs up to
    # 100 steps
    cases["eval"] = (spec, [t[:EVAL_BATCH] for t in slice_preds],
                     h_dev[:EVAL_BATCH], EVAL["obj_thresh"], EVAL["max_out"],
                     EVAL["iou_thresh"])
    head_times, head_dev = {}, {}
    for name in ("slice", "sparse", "dense", "eval"):
        timed = time_head(name, *cases[name], device, tag)
        head_times[name], head_dev[name] = timed[:4], timed[4]

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

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ann = synthetic_ann_list(tmp, n=256, class_num=spec.class_num)
        print(f"data: {len(ann)} synthetic JPEGs written in "
              f"{time.perf_counter() - t0:.1f} s")
        rot, step_ms, fused_ms = train_phases(device, tag, ann,
                                              built["rotate3shear"][1])
        # ---- 10. NMS alone: kernel against its plain version -----------
        nms_err = nms_kernel_phase(spec, spec3, device)
        # ---- 11. the two-stage head on the serving scenes --------------
        nms_launches = two_stage_phase(spec, scenes, scene_preds, h_dev)
        # ---- 12. the fused block on the served net's blocks ------------
        dw, dw_inputs = dwsep_phase(pred, on_gpu, c_dev, h_dev, part, tag)
        # ---- 13. VOC eval ----------------------------------------------
        eval_phase(net, spec, ann, device, tag)
        # ---- 14. times of NMS alone and the fused block -----------------
        nms_t, dw_t = new_kernel_times(scenes, scene_preds, spec, h_dev,
                                       dw_inputs, pred, tag)
        print(f"peak device memory: "
              f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB {tag}")
        # ---- 15. the builders -------------------------------------------
        t0 = time.perf_counter()
        builders_phase(device, tag, ann, canvases, hws, image)
        print(f"builders: wall seconds {time.perf_counter() - t0:.1f}")
        # ---- 16. the entry points ----------------------------------------
        weights, anchors = entry_points_phase(device, tag, ann, tmp)
        # ---- 17. quantized serving, the export, keras_freeze, Helper ------
        t0 = time.perf_counter()
        q_launches, q_rot = quantized_phase(device, tag, ann, spec, net,
                                            canvases, hws, image, weights,
                                            anchors)
        print(f"quantized: wall seconds {time.perf_counter() - t0:.1f}")
        # ---- 18. any candidate count, the stem modes, data parallel -------
        (p18_head, p18_head_global), (p18_nms, p18_nms_global), \
            head_global_t, nms_global_t = any_n_stems_and_dp_phase(
                device, tag, ann, canvases, hws, image)
        # ---- 19. training on the data axis --------------------------------
        p19_rot = mesh_training(device, tag, ann)
        # ---- 20-22. the model and space axes, every builder and mode -------
        tpsp_head, tpsp_head_global, tpsp_rot = tpsp_phase(tag, ann)
        # ---- 23. the benchmark program and the entry contracts -----------
        p23_head, p23_rot = bench_entry_phase(
            device, tag, BATCH * 1e3 / serve_ms, step_ms, fused_ms)
    # ---- 24. the conv epilogue on the served nets -------------------------
    epilogue = epilogue_phase(device, tag)

    k_ms, p_ms, b_ms, b_by = head_times["slice"]
    print(json.dumps({"kernels": [{
        "name": "yolo_head_decode_nms",
        "route": "cuda",
        "source": "k210_yolo_framework_tpu_torch/csrc/yolo_head.cu",
        "replaces": "k210_yolo_framework_tpu/ops/yolo_head_pallas.py:140",
        "launches": launches + q_launches + p18_head + tpsp_head + p23_head,
        "global_launches": p18_head_global + tpsp_head_global,
        "max_abs_err": max(max_err, slice_err),
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
        "device_ms": head_dev["slice"],
        "global_path": head_global_t,
    }, {
        "name": "rotate3shear",
        "route": "cuda",
        "source": "k210_yolo_framework_tpu_torch/csrc/rotate3shear.cu",
        "replaces": "k210_yolo_framework_tpu/ops/rotate_pallas.py:113",
        **rot,
        "launches": rot["launches"] + q_rot + p19_rot + tpsp_rot + p23_rot,
    }, {
        "name": "nms_select",
        "route": "cuda",
        "source": "k210_yolo_framework_tpu_torch/csrc/nms.cu",
        "replaces": "k210_yolo_framework_tpu/ops/nms_pallas.py:171",
        "launches": nms_launches + p18_nms,
        "global_launches": p18_nms_global,
        "max_abs_err": nms_err,
        **nms_t["sparse"],
        "library_ms": None,
        "global_path": nms_global_t,
    }, {
        "name": "dwsep_fused_block",
        "route": "cuda",
        "source": "k210_yolo_framework_tpu_torch/csrc/dwsep.cu",
        "replaces": "k210_yolo_framework_tpu/ops/dwsep_pallas.py:78",
        **dw,
        "ms": dw_t["ms"],
        "plain_ms": dw_t["plain_ms"],
        "bound_ms": dw_t["bound_ms"],
        "bound_by": dw_t["bound_by"],
        "library_ms": None,
    }, {
        "name": "conv_epilogue",
        "route": "cuda",
        "source": "k210_yolo_framework_tpu_torch/csrc/conv_epilogue.cu",
        "replaces": None,
        **epilogue,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

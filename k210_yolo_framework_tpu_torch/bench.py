"""Benchmarks of the port for the demo config (yolo_mobilev1-0.75 at
224x320, VOC), one JSON line a mode:

    python -m k210_yolo_framework_tpu_torch.bench [--mode M] [--device cuda]

The counterpart of the repository's root ``bench.py`` (which times the JAX
package), function for function, with the root's flags, choices and
defaults and one more flag, ``--device`` (default ``cuda``; a missing card
raises, nothing falls back to the CPU; ``--device cpu`` runs the same code
on the CPU for the tests, and its numbers are no card's).  Modes:

  serve    (default)  end-to-end serving: uint8 frames in, NMS'd detections
                      out (letterbox + bf16 forward + the fused decode/NMS
                      head kernel), 240x320 canvases resident on the device;
                      plus the batch-1 program's latency.
  serve_dual          two independent dependency chains interleaved, each
                      on its own CUDA stream: a serving frontend with 2
                      in-flight batches.
  serve_dense         worst-case scenes: +3 on every output conv's conf and
                      class biases, so every candidate clears obj_thresh for
                      every class and each class row's greedy NMS runs to
                      max_out (asserted: every class list is full).
  serve512            the same program on the 512x512 staging canvas
                      (``data/pipeline.CANVAS_HW``).
  serve_int8          serving from per-channel int8 conv kernels.
  serve_int8act[_sym|_cal]
                      int8 x int8 -> int32 conv compute with dynamic affine,
                      dynamic symmetric or calibrated activation ranges
                      (``_cal`` calibrates on the canvases first).
  serve_scan          K=8 chained serving calls captured in one CUDA graph
                      and replayed: the device's rate with the host's
                      launch path taken out (the root's ``lax.scan`` in one
                      dispatched program).  On a card that cannot capture it
                      raises; on the CPU (tests) it runs the K calls eagerly
                      and says so (``cuda_graph``: false).
                      ``graph_replays`` counts the replays, each K head
                      kernel launches the wrapper's count leaves out.
  loader              512 synthetic JPEGs through ``DataPipeline`` (256x320
                      canvases, prefetch 2) -> host-to-device copy ->
                      serving, at most 2 batches in flight.
  train               chained train steps (batch 128, bf16 convs, fp32
                      loss and parameters): imgs/s, ms/step and the model
                      FLOP rate against the H100's dense bf16 peak.
  train_e2e           the fused preprocess (512-canvas letterbox, augment
                      with the rotation kernel, /max, label encode, bf16
                      pixels) plus the train step.
  all                 serve, serve512, serve_int8, serve_scan, loader,
                      train and train_e2e, one line each.

Method (as the root's): each serving iteration's canvas depends on the last
iteration's result (a data-dependent +0/+1 bump), so the timed loop is one
dependency chain; a round ends in a host fetch of the last result
(``float``, which waits for the device), and ``value`` is the best of 3
rounds on the host's clock.  On one stream the work is already ordered; the
chain is kept so that a number means what the root's means.  Beside it,
``window_value`` is all 3 rounds' work over their summed time, which a
stall in any round moves.  ``_latency_ms`` times synchronous round trips
(p50 / p99) on the host's clock.  The ``*_device_ms`` keys are on the
device's clock: CUDA events recorded on the stream before a round's first
call and after its last, divided by the calls, best of 3 (``_device_ms``:
a chained loop of 200 calls).  That is the device's time a call, its idle
gaps included where the host's launches fall behind it; on the CPU it is
the host's clock.  Each train step chains through the state.  The batch
sizes and iteration counts are the module's constants.

Every line carries ``"device"``: the card's name, its power limit from
``nvidia-smi`` and the card count, or ``{"name": "cpu"}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from functools import partial
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["H100_BF16_TFLOPS", "Setup", "bench_loader", "bench_serve",
           "bench_serve_scan", "bench_train", "bench_train_e2e",
           "device_info", "main", "parse_args"]

# Defaults = the reference demo config; --model_def / --depth_multiplier /
# --batch_size measure any builder.
MODEL_DEF = "yolo_mobilev1"
ALPHA = 0.75
STEM_MODE = "default"
SERVE_BATCH = 128
TRAIN_BATCH = 128
TRAIN_E2E_BATCH = 128
# iteration counts (the root's): timed serving calls a round, synchronous
# round trips, chained calls for _device_ms, calls a captured graph and
# graph replays a round, the loader's JPEGs, probe batches and timed
# batches, train steps a round; best of ROUNDS
SERVE_ITERS = 50
LATENCY_CALLS = 40
DEVICE_ITERS = 200
SCAN_K = 8
SCAN_ITERS = 8
LOADER_IMAGES = 512
LOADER_PROBES = 6
LOADER_BATCHES = 12
TRAIN_ITERS = 30
ROUNDS = 3
# NVIDIA H100 SXM, dense bf16 tensor-core peak (data sheet), TFLOP/s
H100_BF16_TFLOPS = 989.0


@dataclass(frozen=True)
class Setup:
    """What the command line chose: the device, the builder, its width and
    serving stem, and a batch override (0: each mode's constant)."""
    device: torch.device
    model_def: str = MODEL_DEF
    alpha: float = ALPHA
    stem_mode: str = STEM_MODE
    batch: int = 0


def device_info(device: torch.device) -> dict:
    """The device a line was measured on: a card's name, power limit (W,
    from ``nvidia-smi``) and the card count; ``{"name": "cpu"}`` on the
    CPU."""
    if device.type != "cuda":
        return {"name": "cpu"}
    rows = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    limit = rows[device.index or 0].rsplit(",", 1)[1].split()[0]
    try:
        watts = float(limit)
    except ValueError:       # "[N/A]" where the card reports none
        watts = None
    return {"name": torch.cuda.get_device_name(device),
            "power_limit_w": watts, "count": torch.cuda.device_count()}


def _staging_canvas_hw() -> Tuple[int, int]:
    """The production staging-canvas size, from the port's pipeline
    (``data/pipeline.CANVAS_HW``)."""
    from k210_yolo_framework_tpu_torch.data.pipeline import CANVAS_HW
    return CANVAS_HW


def _demo_spec(model_def: str = MODEL_DEF):
    """The VOC demo spec: 2 output layers, or 3 (strides 32/16/8, the third
    layer's anchors half the others') for the darknet53 ``yolo``."""
    from k210_yolo_framework_tpu_torch.config import (
        VOC_ANCHORS,
        YoloSpec,
        voc_spec,
    )

    if model_def == "yolo":
        anchors = np.concatenate(
            [np.asarray(VOC_ANCHORS), np.asarray(VOC_ANCHORS)[1:] * 0.5], 0)
        return YoloSpec.create((224, 320), ((7, 10), (14, 20), (28, 40)),
                               20, anchors)
    return voc_spec()


def _demo_net(setup: Setup, spec):
    """``build_network``'s seeded weights (generator seed 0)."""
    from k210_yolo_framework_tpu_torch.models import build_network

    return build_network(setup.model_def, spec.in_hw, spec.nanchors,
                         spec.class_num, alpha=setup.alpha,
                         generator=torch.Generator().manual_seed(0))


def _dense_scene_state(net: torch.nn.Module, spec) -> Dict[str, torch.Tensor]:
    """``net``'s state with +3 on every output conv's conf and class biases,
    so every candidate clears obj_thresh for every class and every class
    row's greedy NMS runs to max_out (the reference's own worst case is
    region_layer.c's O(C n^2) NMS over every box above the threshold)."""
    na, nc = spec.nanchors, spec.class_num
    bump = np.zeros(na * (5 + nc), np.float32)
    for a in range(na):
        bump[a * (5 + nc) + 4:(a + 1) * (5 + nc)] = 3.0   # conf, classes
    state = {k: v.clone() for k, v in net.state_dict().items()}
    for k, v in state.items():
        if k.endswith("dark_conv_out.bias"):
            v += torch.from_numpy(bump).to(v)
    return state


def _demo_predictor(setup: Setup, quantize: Optional[str] = None,
                    dense: bool = False):
    """(spec, bf16 Predictor at obj_thresh 0.7, iou_thresh 0.3); the stem
    mode applies where ``quantize`` is None or ``"int8"``, as the root's."""
    from k210_yolo_framework_tpu_torch.inference import Predictor

    spec = _demo_spec(setup.model_def)
    net = _demo_net(setup, spec)
    stem = setup.stem_mode if quantize in (None, "int8") else "default"
    pred = Predictor(net, _dense_scene_state(net, spec) if dense else None,
                     spec, obj_thresh=0.7, iou_thresh=0.3,
                     compute_dtype=torch.bfloat16, quantize=quantize,
                     stem_mode=stem, device=setup.device)
    return spec, pred


def _serve_inputs(batch: int, canvas_hw, device, seed: int = 0):
    """(canvases u8 numpy, img_hws numpy, both on ``device``): random
    canvases, every image the whole canvas."""
    rng = np.random.default_rng(seed)
    canv = rng.integers(0, 256, (batch, *canvas_hw, 3)).astype(np.uint8)
    hws = np.tile(np.asarray(canvas_hw, np.int32), (batch, 1))
    return (canv, hws, torch.from_numpy(canv).to(device),
            torch.from_numpy(hws).to(device))


def _window(device: torch.device,
            work: Callable[[], Callable[[], None]]) -> Tuple[float, float]:
    """(host s, device s) of one timed window: ``work()`` enqueues the
    window's calls and returns the host fetch that ends it.  The host's
    clock runs from before the calls to after the fetch; the device's
    (on a card) between CUDA events recorded on the current stream before
    the first call and after the last one, before the fetch.  On the CPU
    both are the host's."""
    start = end = None
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
    t0 = time.perf_counter()
    fetch = work()
    if end is not None:
        end.record()
    fetch()
    host = time.perf_counter() - t0
    return host, host if start is None else start.elapsed_time(end) / 1e3


def _rounds(device: torch.device, work: Callable[..., Callable[[], None]],
            prepare: Callable[[], tuple] = tuple) -> Tuple[float, float,
                                                           float]:
    """ROUNDS windows of ``work(*prepare())`` (:func:`_window`; ``prepare``
    runs before each, untimed): (the best round's host s, all rounds' host
    s together, the best round's device s)."""
    times = [_window(device, partial(work, *prepare()))
             for _ in range(ROUNDS)]
    host = [h for h, _ in times]
    return min(host), sum(host), min(d for _, d in times)


def _chained(pred, img_hws: torch.Tensor) -> Callable:
    """(canvases) -> (next canvases, score sum): one serving call whose
    result bumps the next call's input by a data-dependent 0."""
    @torch.inference_mode()
    def step(canv):
        total = pred._run_batch(canv, img_hws).scores.sum()
        return canv + (total > 1e9).to(torch.uint8), total
    return step


def bench_serve(setup: Setup, canvas_hw=(240, 320),
                metric: str = "e2e_infer_imgs_per_sec_per_chip",
                quantize: Optional[str] = None, chains: int = 1,
                dense: bool = False) -> dict:
    """``chains`` > 1 interleaves that many independent dependency chains,
    each on its own CUDA stream on a card; ``dense`` serves the NMS worst
    case (:func:`_dense_scene_state`)."""
    device = setup.device
    batch = setup.batch or SERVE_BATCH
    spec, pred = _demo_predictor(setup, quantize, dense)
    canv_np, hws_np, canvases, img_hws = _serve_inputs(batch, canvas_hw,
                                                       device)
    if quantize == "int8_act_cal":
        pred.calibrate(canv_np, hws_np)
    step = _chained(pred, img_hws)

    # warm-up on the default stream: the cached constants (letterbox,
    # head geometry, the head's launch plan) are made once, here
    _, out = step(canvases.clone())
    float(out)
    if dense:
        # the worst case is real: every image's per-class detection list
        # is full (max_out is per class), so every greedy loop ran to depth
        n_det = int(pred._run_batch(canvases.clone(), img_hws).valid.sum())
        full = batch * pred.max_out * spec.class_num
        if n_det != full:
            raise AssertionError((n_det, full))

    streams = None
    if chains > 1 and device.type == "cuda":
        streams = [torch.cuda.Stream(device) for _ in range(chains)]

    def on(c):
        """Chain c's stream (its own on a card, with several chains)."""
        return (contextlib.nullcontext() if streams is None
                else torch.cuda.stream(streams[c]))

    def fresh():
        cs = []
        for c in range(chains):
            if streams is not None:
                streams[c].wait_stream(torch.cuda.current_stream(device))
            with on(c):
                cs.append(canvases.clone())  # fresh, on the chain's stream
        return (cs,)

    def work(cs):
        outs = [None] * chains
        for _ in range(iters):
            for c in range(chains):
                with on(c):
                    cs[c], outs[c] = step(cs[c])
        for s in streams or ():              # the end event waits for all
            torch.cuda.current_stream(device).wait_stream(s)
        return lambda: [float(o) for o in outs]   # host fetch: completion

    iters = SERVE_ITERS
    best, total, best_dev = _rounds(device, work, fresh)
    v = chains * batch * iters / best
    # the live camera loop's two numbers per shape: the synchronous round
    # trip, and the device time of a chained call
    lat = _latency_ms(step, canvases.clone())
    line = {"metric": metric, "value": round(v, 1), "unit": "imgs/sec",
            "window_value": round(ROUNDS * chains * batch * iters / total,
                                  1),
            "batch": batch,
            "batch_host_rtt_ms_p50": lat["p50"],
            "batch_host_rtt_ms_p99": lat["p99"],
            "batch_device_ms": round(best_dev / (iters * chains) * 1e3, 3)}
    if chains > 1:
        line["chains"] = chains
    if dense:
        line["dense_scene"] = True
    if metric == "e2e_infer_imgs_per_sec_per_chip":
        # the single-frame (batch-1) program: the camera loop's latency
        canv1 = torch.from_numpy(np.random.default_rng(1).integers(
            0, 256, (1, *canvas_hw, 3)).astype(np.uint8)).to(device)
        step1 = _chained(pred, img_hws[:1])
        lat1 = _latency_ms(step1, canv1.clone())
        line["single_frame_host_rtt_ms_p50"] = lat1["p50"]
        line["single_frame_host_rtt_ms_p99"] = lat1["p99"]
        line["single_frame_device_ms"] = _device_ms(step1, canv1.clone())
    return line


def _device_ms(step: Callable, canv: torch.Tensor,
               iters: Optional[int] = None) -> float:
    """Device ms of one call of a chained (canv) -> (canv, scalar) step: a
    loop of ``iters`` (default DEVICE_ITERS) calls between two CUDA events
    with one host fetch at the end, best of ROUNDS (:func:`_rounds`).
    Where the host's launches keep ahead this is the device's work a
    call; where they fall behind, the idle gaps between calls count too."""
    iters = iters or DEVICE_ITERS
    canv, out = step(canv)
    float(out)

    def work():
        nonlocal canv
        for _ in range(iters):
            canv, out = step(canv)
        return lambda: float(out)

    return round(_rounds(canv.device, work)[2] / iters * 1e3, 3)


def _latency_ms(step: Callable, canv: torch.Tensor,
                n: Optional[int] = None) -> Dict[str, float]:
    """p50 / p99 of ``n`` (default LATENCY_CALLS) synchronous round trips
    of a chained step: each call's result is fetched before the next."""
    n = n or LATENCY_CALLS
    canv, out = step(canv)
    float(out)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        canv, out = step(canv)
        float(out)
        ts.append((time.perf_counter() - t0) * 1e3)
    ts = np.sort(np.asarray(ts))
    return {"p50": round(float(np.percentile(ts, 50)), 3),
            "p99": round(float(np.percentile(ts, 99)), 3)}


def _captured(fn: Callable, example: torch.Tensor) -> Callable:
    """``fn`` (canv) -> (canv, scalar) captured once in a CUDA graph.  The
    graph reads a static input canvas and writes ``fn``'s next canvas back
    into it, so replays chain; the returned step copies a canvas in when it
    is given another one, replays, and returns (static canvas, scalar).
    Its ``replays`` counts the replays.  A path that syncs the host or
    copies from it raises in the capture.  The head kernel's wrapper
    counts the calls it captures, which launch nothing; the count is set
    back after the capture, and a replay's launches are the graph's, in
    ``replays`` (``fused_decode_nms.launches`` counts launches that ran
    eagerly only)."""
    from k210_yolo_framework_tpu_torch.ops.yolo_head_pallas import (
        fused_decode_nms as head,
    )

    device = example.device
    static = example.clone()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):       # warm-up off the default stream
        for _ in range(2):
            fn(static.clone())
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    counted = head.launches, head.global_launches
    with torch.cuda.graph(graph):
        nxt, total = fn(static)
        static.copy_(nxt)
    head.launches, head.global_launches = counted

    def step(canv):
        if canv is not static:
            static.copy_(canv)
        graph.replay()
        step.replays += 1
        return static, total

    step.replays = 0
    return step


def bench_serve_scan(setup: Setup, canvas_hw=(240, 320),
                     k: Optional[int] = None) -> dict:
    """Serving at the device's rate: K (default SCAN_K) chained calls a
    replay of one CUDA graph."""
    device = setup.device
    k = k or SCAN_K
    batch = setup.batch or SERVE_BATCH
    _, pred = _demo_predictor(setup)
    _, _, canvases, img_hws = _serve_inputs(batch, canvas_hw, device)
    body = _chained(pred, img_hws)

    def scan(canv):
        totals = []
        for _ in range(k):
            canv, total = body(canv)
            totals.append(total)
        return canv, torch.stack(totals).sum()

    _, out = scan(canvases.clone())           # eager warm-up
    float(out)
    step = _captured(scan, canvases) if device.type == "cuda" else scan
    _, out = step(canvases.clone())
    float(out)

    def work(canv):
        for _ in range(iters):
            canv, out = step(canv)
        return lambda: float(out)

    iters = SCAN_ITERS
    best, total, _ = _rounds(device, work, lambda: (canvases.clone(),))
    graph = device.type == "cuda"
    return {"metric": "device_roofline_infer_imgs_per_sec_per_chip",
            "value": round(batch * k * iters / best, 1), "unit": "imgs/sec",
            "window_value": round(ROUNDS * batch * k * iters / total, 1),
            "batch": batch, "scan_k": k, "cuda_graph": graph,
            "graph_replays": step.replays if graph else 0}


def bench_loader(setup: Setup) -> dict:
    """Sustained loader -> device -> detections over on-disk JPEGs: host
    decode and staging, the host-to-device copy and the serving program,
    on the serving canvas tier (256x320).  Host-bound by design; the line
    reports the host's cores, its decode+stage rate alone and the copy's
    rate, so the overlap is measured, not argued."""
    from k210_yolo_framework_tpu_torch.data.pipeline import (
        DataPipeline,
        synthetic_ann_list,
    )

    device = setup.device
    batch = setup.batch or SERVE_BATCH
    _, pred = _demo_predictor(setup)
    tmp = tempfile.mkdtemp(prefix="bench_jpegs_")
    it = None
    try:
        ann = synthetic_ann_list(tmp, n=LOADER_IMAGES, seed=0)
        pipe = DataPipeline(ann, batch_size=batch, seed=0,
                            canvas_hw=(256, 320), prefetch=2)
        it = iter(pipe)

        @torch.inference_mode()
        def run(hb):
            return pred._run_batch(torch.from_numpy(hb.canvases).to(device),
                                   torch.from_numpy(hb.img_hws).to(device)
                                   ).scores.sum()

        float(run(next(it)))                    # warm-up

        t0 = time.perf_counter()
        probes = [next(it) for _ in range(LOADER_PROBES)]
        t_decode = time.perf_counter() - t0
        t0 = time.perf_counter()
        for p in probes:
            torch.from_numpy(p.canvases).to(device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_h2d = time.perf_counter() - t0
        nbytes = probes[0].canvases.nbytes
        decode_rate = LOADER_PROBES * batch / max(t_decode, 1e-9)
        h2d_gbps = LOADER_PROBES * nbytes / max(t_h2d, 1e-9) / 1e9
        del probes

        t0 = time.perf_counter()
        pending = []
        for _ in range(LOADER_BATCHES):
            pending.append(run(next(it)))
            if len(pending) > 2:                # at most 2 in flight
                float(pending.pop(0))
        for p in pending:
            float(p)
        v = LOADER_BATCHES * batch / (time.perf_counter() - t0)
        return {"metric": "loader_e2e_imgs_per_sec_per_chip",
                "value": round(v, 1), "unit": "imgs/sec", "batch": batch,
                "native_loader": pipe.use_native,
                "host_cores": os.cpu_count(),
                "host_decode_stage_imgs_per_sec": round(decode_rate, 1),
                "h2d_gbps": round(h2d_gbps, 2)}
    finally:
        if it is not None:
            it.close()                          # stops the loader threads
        shutil.rmtree(tmp, ignore_errors=True)


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride,
                        _padding, _dilation, transposed, _output_padding,
                        _groups, output_mask, out_shape=None,
                        **_kw) -> int:
    """``aten.convolution_backward``'s FLOPs: each of its two products
    (input gradient, weight gradient) costs the forward's 2 * B * spatial *
    prod(weight shape).  torch's own formula takes the weight gradient's
    channel product over every input channel, ignoring groups: a
    depthwise conv's by a factor of its channel count too many."""
    spatial = (x_shape if transposed else grad_out_shape)[2:]
    fwd = 2 * grad_out_shape[0] * math.prod(spatial) * math.prod(w_shape)
    return fwd * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def _step_flops(step: Callable, *args):
    """(step's result, its FLOPs): one call under
    ``torch.utils.flop_counter.FlopCounterMode``, which counts the convs and
    matmuls forward and backward (not the elementwise work, the loss's
    reductions or the optimizer), with the conv backward counted per group
    (:func:`_conv_backward_flop`)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False, custom_mapping={
            torch.ops.aten.convolution_backward: _conv_backward_flop}) as c:
        out = step(*args)
    return out, c.get_total_flops()


def _train_inputs(batch: int, spec, device):
    """The root's fixed train batch: 4 boxes an image, uniform pixels."""
    from k210_yolo_framework_tpu_torch.ops import codec as C

    rng = np.random.default_rng(0)
    boxes = np.concatenate([
        rng.integers(0, 20, (batch, 4, 1)).astype(np.float32),
        rng.uniform(0.2, 0.8, (batch, 4, 2)),
        rng.uniform(0.1, 0.4, (batch, 4, 2))], -1).astype(np.float32)
    labels = tuple(C.encode_labels_batch(
        torch.from_numpy(boxes).to(device),
        torch.ones((batch, 4), dtype=torch.bool, device=device), spec))
    images = torch.from_numpy(rng.uniform(
        0, 1, (batch, *spec.in_hw, 3)).astype(np.float32)).to(device)
    return images, labels


def bench_train(setup: Setup) -> dict:
    """Chained train steps on one fixed batch (the state chains them): the
    loop's imgs/s and ms/step, and the model FLOP rate of the convs
    (:func:`_step_flops`) against the H100's dense bf16 peak."""
    from k210_yolo_framework_tpu_torch.config import TrainConfig
    from k210_yolo_framework_tpu_torch.training import train as TT

    device = setup.device
    batch = setup.batch or TRAIN_BATCH
    spec = _demo_spec(setup.model_def)
    cfg = TrainConfig(batch_size=batch)
    state = TT.create_train_state(_demo_net(setup, spec), cfg, device)
    step = TT.make_train_step(spec, cfg, compute_dtype=torch.bfloat16,
                              train_epoch_step=100)
    images, labels = _train_inputs(batch, spec, device)

    (state, logs), flops = _step_flops(step, state, images, labels)
    state, logs = step(state, images, labels)      # warm-up, uncounted
    float(logs["loss"])

    def work():
        nonlocal state
        for _ in range(iters):
            state, logs = step(state, images, labels)
        return lambda: float(logs["loss"])      # host fetch: completion

    iters = TRAIN_ITERS
    best, total, _ = _rounds(device, work)
    tflops = flops / (best / iters) / 1e12
    return {"metric": "train_imgs_per_sec_per_chip",
            "value": round(batch * iters / best, 1), "unit": "imgs/sec",
            "window_value": round(ROUNDS * batch * iters / total, 1),
            "ms_per_step": round(best / iters * 1e3, 2), "batch": batch,
            "model_tflops_per_sec": round(tflops, 2),
            "mfu_vs_h100_989tflops": round(tflops / H100_BF16_TFLOPS, 4)}


def bench_train_e2e(setup: Setup) -> dict:
    """The fused preprocess and train step, the device side of one real
    training step (the ``train`` mode feeds made images): canvases resident
    on the device; the augment's draws come from a generator advanced each
    step (one rotation kernel launch a step)."""
    from k210_yolo_framework_tpu_torch.config import TrainConfig
    from k210_yolo_framework_tpu_torch.data import pipeline as PL
    from k210_yolo_framework_tpu_torch.training import train as TT

    device = setup.device
    batch = setup.batch or TRAIN_E2E_BATCH
    spec = _demo_spec(setup.model_def)
    cfg = TrainConfig(batch_size=batch)
    state = TT.create_train_state(_demo_net(setup, spec), cfg, device)
    pp = PL.make_preprocess_fn(spec, is_training=True, dtype=torch.bfloat16)
    step = TT.make_fused_train_step(spec, cfg, pp, torch.bfloat16,
                                    train_epoch_step=100)

    rng = np.random.default_rng(0)
    canv = torch.from_numpy(rng.integers(
        0, 256, (batch, *_staging_canvas_hw(), 3)).astype(np.uint8)).to(device)
    hws = torch.from_numpy(np.tile(np.asarray([360, 480], np.int32),
                                   (batch, 1))).to(device)
    boxes = torch.from_numpy(np.concatenate([
        rng.integers(0, 20, (batch, 64, 1)).astype(np.float32),
        rng.uniform(0.2, 0.8, (batch, 64, 2)),
        rng.uniform(0.1, 0.4, (batch, 64, 2))], -1).astype(np.float32)
    ).to(device)
    valid = torch.zeros((batch, 64), dtype=torch.bool, device=device)
    valid[:, :4] = True
    gen = torch.Generator().manual_seed(1)

    state, logs = step(state, canv, hws, boxes, valid, gen)   # warm-up
    float(logs["loss"])

    def work():
        nonlocal state
        for _ in range(iters):
            state, logs = step(state, canv, hws, boxes, valid, gen)
        return lambda: float(logs["loss"])

    iters = TRAIN_ITERS
    best, total, _ = _rounds(device, work)
    return {"metric": "train_e2e_imgs_per_sec_per_chip",
            "value": round(batch * iters / best, 1), "unit": "imgs/sec",
            "window_value": round(ROUNDS * batch * iters / total, 1),
            "ms_per_step": round(best / iters * 1e3, 2), "batch": batch}


MODES = ("serve", "serve_dual", "serve_dense", "serve512", "serve_int8",
         "serve_int8act", "serve_int8act_sym", "serve_int8act_cal",
         "serve_scan", "loader", "train", "train_e2e", "all")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m k210_yolo_framework_tpu_torch.bench",
        description="Benchmarks of the PyTorch port, one JSON line a mode.")
    ap.add_argument("--mode", default="serve", choices=list(MODES))
    ap.add_argument("--model_def", default=MODEL_DEF,
                    help="any builder under the VOC spec: yolo_mobilev1, "
                         "yolo_mobilev2, tiny_yolo (2 layers) or yolo "
                         "(darknet53, 3 layers)")
    ap.add_argument("--depth_multiplier", type=float, default=ALPHA)
    ap.add_argument("--batch_size", type=int, default=0,
                    help="override every mode's batch (default 128)")
    ap.add_argument("--stem_mode", default="default",
                    choices=["default", "patches", "nativeconv"],
                    help="serving stem variant (inference.Predictor), for "
                         "quantize None or int8: 'patches' = the letterbox "
                         "emits the stem's im2col patches (mobilenet "
                         "builders only)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; a missing card raises")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """Run the chosen mode(s), print one JSON line each and return them."""
    from k210_yolo_framework_tpu_torch.training.train import checked_device

    args = parse_args(argv)
    setup = Setup(checked_device(args.device), args.model_def,
                  args.depth_multiplier, args.stem_mode, args.batch_size)
    serve = partial(bench_serve, setup)
    serve512 = partial(serve, _staging_canvas_hw(),
                       metric="e2e_infer_512canvas_imgs_per_sec_per_chip")
    serve_int8 = partial(serve, metric="e2e_infer_int8w_imgs_per_sec_per_chip",
                         quantize="int8")
    scan = partial(bench_serve_scan, setup)
    loader = partial(bench_loader, setup)
    train = partial(bench_train, setup)
    train_e2e = partial(bench_train_e2e, setup)
    runs = {
        "serve": (serve,),
        "serve_dual": (partial(
            serve, metric="e2e_infer_dual_chain_imgs_per_sec_per_chip",
            chains=2),),
        "serve_dense": (partial(
            serve, metric="e2e_infer_dense_scene_imgs_per_sec_per_chip",
            dense=True),),
        "serve512": (serve512,),
        "serve_int8": (serve_int8,),
        "serve_int8act": (partial(
            serve, metric="e2e_infer_int8act_imgs_per_sec_per_chip",
            quantize="int8_act"),),
        "serve_int8act_sym": (partial(
            serve, metric="e2e_infer_int8act_sym_imgs_per_sec_per_chip",
            quantize="int8_act_sym"),),
        "serve_int8act_cal": (partial(
            serve, metric="e2e_infer_int8act_cal_imgs_per_sec_per_chip",
            quantize="int8_act_cal"),),
        "serve_scan": (scan,),
        "loader": (loader,),
        "train": (train,),
        "train_e2e": (train_e2e,),
        "all": (serve, serve512, serve_int8, scan, loader, train, train_e2e),
    }
    info = device_info(setup.device)
    lines = []
    for run in runs[args.mode]:
        line = dict(run(), device=info)
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()

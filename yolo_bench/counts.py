"""The work the per-layer readers divide by: FLOPs of the nets, bytes and
operations of the two hand-written kernels, and the H100's peaks.

The nets' FLOPs are counted on the reference net at the configuration's
shapes on the ``meta`` device under ``FlopCounterMode`` (convolutions and
matmuls only, forward and, for training, backward), with the conv
backward counted per group: torch's own formula takes a depthwise conv's
weight gradient over every input channel.  The kernels' bounds follow the
port's own bound formulas (one byte read or written once; operations
counted per candidate, per (candidate, class) and per live candidate a
greedy step).
"""

from __future__ import annotations

import math
import torch

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
H100_BF16_FLOPS = 989e12
H100_FP32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": H100_BF16_FLOPS, "float16": H100_BF16_FLOPS,
              "float32": H100_FP32_FLOPS}

DECODE_OPS = 30        # per candidate: 3 sigmoids, 2 exps, letterbox inverse
SCORE_OPS = 4          # per (candidate, class): sigmoid and product
AREA_OPS = 5           # per candidate, once: a box's area
PASS_OPS = 15          # per live candidate and greedy step: intersection,
#                        union, divide, test, argmax
ROT_OPS = 9            # per element: three 2-tap interpolations


def conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride,
                       _padding, _dilation, transposed, _output_padding,
                       _groups, output_mask, out_shape=None, **_kw) -> int:
    """``aten.convolution_backward``: each of its two products (input
    gradient, weight gradient) costs the forward's 2 * B * spatial *
    prod(weight shape), per group."""
    spatial = (x_shape if transposed else grad_out_shape)[2:]
    fwd = 2 * grad_out_shape[0] * math.prod(spatial) * math.prod(w_shape)
    return fwd * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def _net(cfg: dict):
    from yolo_bench.reference import nets as RN
    with torch.device("meta"):
        return RN.build(cfg["model_def"], cfg["anchors_per_layer"],
                        cfg["classes"], cfg.get("alpha", 1.0))


def _count(cfg: dict, backward: bool) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    from yolo_bench.reference import nets as RN
    net = _net(cfg)
    x = torch.zeros((1, *cfg["in_hw"], 3), device="meta")
    ctx = RN.Ctx("train" if backward else "eval")
    with FlopCounterMode(display=False, custom_mapping={
            torch.ops.aten.convolution_backward: conv_backward_flop}) as c:
        outs = RN.forward(net, x, cfg["anchors_per_layer"], ctx)
        if backward:
            sum(o.sum() for o in outs).backward()
    return c.get_total_flops()


def forward_flops(cfg: dict) -> int:
    """Conv FLOPs of one image's forward."""
    return _count(cfg, False)


def train_flops(cfg: dict) -> int:
    """Conv FLOPs of one image's forward and backward."""
    return _count(cfg, True)


def head_work(batch: int, n: int, classes: int, max_out: int,
              live: float) -> dict:
    """Bytes and operations of one head call: the logits read once, the
    candidates' geometry and the letterbox factors, the winners written
    once; decode and areas per candidate, scores per (candidate, class),
    and ``live`` greedy tests."""
    nbytes = 4 * (batch * n * (5 + classes) + 8 * n + 8 * batch
                  + batch * classes * max_out * 5)
    ops = (batch * n * (DECODE_OPS + AREA_OPS)
           + batch * n * classes * SCORE_OPS + live * PASS_OPS)
    return {"bytes": nbytes, "ops": ops}


def bound_s(nbytes: float, ops: float, ops_per_s: float) -> float:
    """The least time: bytes over HBM's rate or operations over the peak,
    whichever is larger."""
    return max(nbytes / H100_HBM_BYTES_PER_S, ops / ops_per_s)


def rotate_work(images: int, h: int, w: int, elem_bytes: int) -> dict:
    """One rotation launch over ``images`` [h, w, 3] images: each element
    read and written once, three two-tap passes."""
    numel = images * h * w * 3
    return {"bytes": 2 * numel * elem_bytes, "ops": numel * ROT_OPS}

"""The fused decode + NMS kernel's least time (logits read and winners
written once at 3.35 TB/s, or decode, scores and the live candidates'
greedy tests at 67 TFLOP/s fp32, whichever is larger) over its traced
time, both a call."""

from yolo_bench.metrics._common import roofline


def read(record):
    return roofline(record, "yolo_head_kernel", record["counts"]["head"])

"""The train step's conv FLOPs, forward and backward (reference net,
depthwise backward per group), over the traced stretch's length, against
989 TFLOP/s bf16."""

from yolo_bench.metrics._common import mfu


def read(record):
    return mfu(record, record["counts"]["train_flops_per_image"])

"""The serving step's conv FLOPs (reference net at the configuration's
shapes) over the traced stretch's length, against 989 TFLOP/s bf16."""

from yolo_bench.metrics._common import mfu


def read(record):
    return mfu(record, record["counts"]["forward_flops_per_image"])

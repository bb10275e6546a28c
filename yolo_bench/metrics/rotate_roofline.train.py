"""The rotation kernel's least time (each pixel read and written once at
3.35 TB/s, or three two-tap passes at 67 TFLOP/s) over its traced time,
both a step."""

from yolo_bench.metrics._common import roofline


def read(record):
    return roofline(record, "rotate_kernel", record["counts"]["rotate"])

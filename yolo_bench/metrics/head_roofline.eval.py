"""``head_roofline.serve`` of the scoring cell: the fused decode + NMS
kernel's least time over its traced time."""

from yolo_bench.metrics._common import reader_of

read = reader_of("head_roofline.serve")

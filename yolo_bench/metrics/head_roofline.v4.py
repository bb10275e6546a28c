"""``head_roofline.serve`` of the YOLOv4 scoring cell: the fused decode +
NMS kernel's least time over its traced time, on its global path with
``scale_x_y``."""

from yolo_bench.metrics._common import reader_of

read = reader_of("head_roofline.serve")

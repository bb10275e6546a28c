"""``idle_share.serve`` of the YOLOv4 scoring cell: the traced stretch's
share with no device operation running."""

from yolo_bench.metrics._common import reader_of

read = reader_of("idle_share.serve")

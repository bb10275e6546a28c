"""``mfu.serve`` of the YOLOv4 scoring cell: the step's conv FLOPs (the
reference YOLOv4 at the configuration's shapes) over the traced stretch,
against the configuration's dense peak (989 TFLOP/s bf16)."""

from yolo_bench.metrics._common import reader_of

read = reader_of("mfu.serve")

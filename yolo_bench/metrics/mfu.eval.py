"""``mfu.serve`` of the scoring cell: the step's conv FLOPs over the
traced stretch, against the configuration's dense peak."""

from yolo_bench.metrics._common import reader_of

read = reader_of("mfu.serve")

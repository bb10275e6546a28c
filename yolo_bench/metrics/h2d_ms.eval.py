"""``h2d_ms.serve`` of the scoring cell: device ms a call of the copies
between host and card."""

from yolo_bench.metrics._common import reader_of

read = reader_of("h2d_ms.serve")

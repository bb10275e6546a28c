"""``letterbox_device_ms.serve`` of the scoring cell: device ms a call
outside the net and the head kernel."""

from yolo_bench.metrics._common import reader_of

read = reader_of("letterbox_device_ms.serve")

"""``net_device_ms.serve`` of the scoring cell: device ms a call inside
``Predictor.net``'s forward."""

from yolo_bench.metrics._common import reader_of

read = reader_of("net_device_ms.serve")

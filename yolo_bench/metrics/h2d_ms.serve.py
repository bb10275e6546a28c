"""Device ms a call of the copies between host and card (the canvases
in, the detections out)."""

from yolo_bench.metrics._common import per_call_ms


def read(record):
    tr = record["trace"]
    return None if tr is None else per_call_ms(record, tr["copies_s"])

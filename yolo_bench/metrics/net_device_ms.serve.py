"""Device ms a call of the kernels launched inside ``Predictor.net``'s
forward (the harness's hooks on the net)."""

from yolo_bench.metrics._common import per_call_ms


def read(record):
    tr = record["trace"]
    if tr is None or "net" not in tr["spans"]:
        return None
    return per_call_ms(record, tr["spans"]["net"]["device_s"])

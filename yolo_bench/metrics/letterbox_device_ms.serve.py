"""Device ms a call of the kernels the entry call launches outside the
net's forward and the head kernel: the letterbox and the glue around the
head (the logits' flatten, the letterbox inverse, the winners' masks)."""

from yolo_bench.metrics._common import per_call_ms


def read(record):
    tr = record["trace"]
    if tr is None or "call" not in tr["spans"]:
        return None
    span = tr["spans"]["call"]
    head = sum(s for n, s in span["ops"].items() if "yolo_head" in n)
    return per_call_ms(record, span["device_s"] - head)

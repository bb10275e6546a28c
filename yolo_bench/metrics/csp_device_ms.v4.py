"""Device ms a call inside the port's ``net.csp`` span (YOLOv4's
CSPDarknet53 trunk, ``models/cspdarknet.py``): the kernels its host ops
launched, the conv epilogue's included (``trace.program_spans``).  None
where the port has no such span."""

from yolo_bench.metrics._common import per_call_ms


def read(record):
    span = (record["trace"] or {}).get("program", {}).get("net.csp")
    return None if span is None else per_call_ms(record, span["device_s"])

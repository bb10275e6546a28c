"""Device ms a call inside the port's ``net.spp`` and ``net.pan`` spans
(YOLOv4's neck: SPP with its two conv stacks, PANet's two paths and the
3x3 before each output conv, ``models/yolonet.YoloV4``).  None where the
port has neither span."""

from yolo_bench.metrics._common import per_call_ms


def read(record):
    program = (record["trace"] or {}).get("program", {})
    spans = [program[k] for k in ("net.spp", "net.pan") if k in program]
    if len(spans) < 2:
        return None
    return per_call_ms(record, sum(s["device_s"] for s in spans))

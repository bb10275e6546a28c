"""Device ms a step of the preprocess (letterbox, augment with the
rotation kernel, /max, label encode): the kernels launched inside the
harness's span around the preprocess function it hands the train step,
and the rotation kernel, which the program launches through its own
library."""

from yolo_bench.metrics._common import kernel_s, per_call_ms


def read(record):
    tr = record["trace"]
    if tr is None or "preprocess" not in tr["spans"]:
        return None
    span = tr["spans"]["preprocess"]
    spent = span["device_s"]
    if not any("rotate_kernel" in n for n in span["ops"]):
        spent += kernel_s(record, "rotate_kernel")
    return per_call_ms(record, spent)

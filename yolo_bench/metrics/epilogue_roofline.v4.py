"""The conv epilogue kernel's least time over its traced time, both a
call: the bytes of the work (``_epilogue_bytes``: each eval ConvBN's conv
output read once, its residual read once in fp32 where it has one, its
output written once in the width the net stores) at 3.35 TB/s, over the
device time of every launch of ``csrc/conv_epilogue.cu``'s two kernels
(``epilogue_kernel``: none, ReLU, ReLU6, LeakyReLU; ``epilogue_mish_kernel``:
Mish).  None where neither ran."""

from yolo_bench import counts as C
from yolo_bench.metrics import _common
from yolo_bench.metrics._epilogue_bytes import epilogue_bytes

KERNELS = ("epilogue_kernel", "epilogue_mish_kernel")


def read(record):
    tr = record["trace"]
    spent = sum(_common.kernel_s(record, k) for k in KERNELS) if tr else 0.0
    if spent <= 0:
        return None
    nbytes = epilogue_bytes(record["config"], int(record["traffic"]["batch"]))
    bound = nbytes / C.H100_HBM_BYTES_PER_S
    return 100.0 * bound * tr["calls"] / spent

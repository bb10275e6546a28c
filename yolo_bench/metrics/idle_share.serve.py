"""The traced stretch's share with no device operation running."""

from yolo_bench.metrics._common import idle_share


def read(record):
    return idle_share(record)

"""Numpy-only helpers (colormap, detection matching), the TensorBoard event
writer and the console prefixes of the command-line entry points."""

from k210_yolo_framework_tpu_torch.utils.console import (  # noqa: F401
    ERROR,
    INFO,
    NOTE,
)

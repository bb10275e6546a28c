"""Numpy-only helpers (colormap, detection matching), the TensorBoard event
writer, the console prefixes of the command-line entry points and their
``--quantize`` parsing."""

from typing import Optional

from k210_yolo_framework_tpu_torch.utils.console import (  # noqa: F401
    ERROR,
    INFO,
    NOTE,
)


def quantize_mode(flag: str) -> Optional[str]:
    """The ``--quantize`` string -> a ``Predictor`` quantize mode: 'true' /
    'int8' -> 'int8'; 'int8_act', 'int8_act_sym', 'int8_act_cal' as they
    are; 'false', 'none', '', '0', 'no' -> None.  Anything else raises, so
    that a mistyped mode never serves fp32 under a quantized name."""
    v = str(flag).lower()
    if v in ("true", "int8"):
        return "int8"
    if v in ("int8_act", "int8_act_sym", "int8_act_cal"):
        return v
    if v in ("false", "none", "", "0", "no"):
        return None
    raise ValueError(
        f"unknown --quantize value {flag!r}; expected one of "
        "True/int8, int8_act, int8_act_sym, int8_act_cal, False")

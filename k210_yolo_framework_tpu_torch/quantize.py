"""Post-training int8 quantization of a state dict.

Counterpart of ``k210_yolo_framework_tpu/quantize.py`` on the port's state
dicts.  Every conv kernel (a tensor whose bridge name,
``training.checkpoint.native_key``, ends in ``/kernel``: the stem, the
depthwise and pointwise convs and the biased head convs) becomes a
:class:`QTensor`, symmetric int8 with one fp32 scale per output channel
(dim 0 of a torch weight ``[O, I, kh, kw]``; JAX reduces axes (0, 1, 2) of
HWIO).  Biases and the BatchNorm terms and statistics stay fp32.

The arithmetic is the JAX package's, in its order:
``scale = max(amax, 1e-12) / 127``, ``q = clip(round(w / scale), -127,
127)`` with ``round`` half to even, so a quantized state equals JAX's
``quantize_tree`` of the same weights through the bridge, bit for bit, on
the CPU and on a card alike (``models.layers.exact_div``: CUDA, like
``jax.jit`` on XLA:CPU, would compute ``amax * (1/127)``, an ulp away on
some channels).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping, NamedTuple

import torch

from k210_yolo_framework_tpu_torch.models.layers import exact_div
from k210_yolo_framework_tpu_torch.training.checkpoint import native_key

__all__ = ["QTensor", "quantize_state", "dequantize_state",
           "fake_quant_state", "is_quantized", "quantize_tree",
           "dequantize_tree", "fake_quant_tree"]


class QTensor(NamedTuple):
    """Symmetric int8 tensor: ``dequant = q.float() * scale``; ``scale``
    broadcasts against ``q`` ([O, 1, 1, 1] for a conv weight, a scalar for
    a tensor of rank < 2)."""

    q: torch.Tensor       # int8
    scale: torch.Tensor   # fp32


def quantize_tensor(w: torch.Tensor) -> QTensor:
    """One tensor -> its QTensor, per output channel (dim 0) at rank >= 2."""
    w = w.detach().to(torch.float32)
    if w.ndim >= 2:
        amax = torch.amax(w.abs(), dim=tuple(range(1, w.ndim)), keepdim=True)
    else:
        amax = torch.amax(w.abs())
    scale = exact_div(torch.clamp_min(amax, 1e-12), 127.0)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return QTensor(q, scale)


def should_quantize(name: str, t: torch.Tensor) -> bool:
    """The JAX ``_should_quantize`` gate: a floating tensor of rank >= 2
    whose bridge name ends in ``/kernel``."""
    if t.ndim < 2 or not t.is_floating_point():
        return False
    try:
        return native_key(name, t.ndim).endswith("/kernel")
    except KeyError:
        return False


def quantize_state(state: Mapping[str, torch.Tensor]
                   ) -> "OrderedDict[str, object]":
    """A state dict -> the same dict with every conv kernel a QTensor."""
    return OrderedDict((k, quantize_tensor(v) if should_quantize(k, v) else v)
                       for k, v in state.items())


def dequantize_state(state: Mapping[str, object],
                     dtype: torch.dtype = torch.float32
                     ) -> "OrderedDict[str, torch.Tensor]":
    """QTensor entries -> dense ``q.to(dtype) * scale.to(dtype)``."""
    return OrderedDict(
        (k, v.q.to(dtype) * v.scale.to(dtype) if isinstance(v, QTensor)
         else v) for k, v in state.items())


def fake_quant_state(state: Mapping[str, torch.Tensor]
                     ) -> "OrderedDict[str, torch.Tensor]":
    """Quantize, then dequantize: an fp32 state carrying int8 weights."""
    return dequantize_state(quantize_state(state))


def is_quantized(state: Mapping[str, object]) -> bool:
    return any(isinstance(v, QTensor) for v in state.values())


# the JAX package's names
quantize_tree = quantize_state
dequantize_tree = dequantize_state
fake_quant_tree = fake_quant_state

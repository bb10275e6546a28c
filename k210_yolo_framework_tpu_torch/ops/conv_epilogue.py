"""The inference epilogue of a conv: eval-mode BatchNorm, the activation, an
optional residual add and the store in the next conv's dtype, in one pass.

No counterpart in the JAX package: XLA fuses these elementwise steps into
the conv on the TPU, while eager PyTorch runs each as a pass of its own
over the conv's output.  ``models.layers.ConvBN`` takes this function in
eval mode when no gradient is recorded (its docstring says when).

``conv_epilogue_reference`` is the plain version, ``BatchNorm.forward``'s
eval arithmetic as the layers run it, step by step::

    x * scale.to(x.dtype)         (the stem's per-image post-conv scale)
    t = x.to(fp32) - mean; t *= mul; t += bias
    the activation, in place      (F.relu, clamp_(0, 6), F.leaky_relu)
    t += residual                 (fp32)
    t.to(store)

``store`` is fp32, or ``x``'s dtype where every consumer of the output
casts to that dtype first: rounding once here gives the bits the
consumer's ``.to()`` would, and its cast becomes a no-op.

``conv_epilogue`` dispatches by the device of ``x``: CPU tensors go through
the plain version; CUDA tensors through ``csrc/conv_epilogue.cu``, which
equals it bit for bit, counted in ``conv_epilogue.launches``; any other
device raises.  Nothing falls back from the kernel.  The kernel is launched
from inside the registered operator ``torch.ops.k210.conv_epilogue``, so a
profiler ties it to that host op, and so to the span around the net's
forward that holds it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from k210_yolo_framework_tpu_torch.ops import _build

__all__ = ["ACTS", "conv_epilogue", "conv_epilogue_reference"]

# activation kinds, in the kernel's numbering
ACTS = ("none", "relu", "relu6", "leaky_relu")

# the kernel's type codes
_TYPES = {torch.float32: 0, torch.bfloat16: 1}
# its layouts: 8 channels of a pixel a thread, or an element a thread
_CHANNELS_LAST, _SCALAR = 0, 1


def conv_epilogue_reference(x: torch.Tensor, mean: torch.Tensor,
                            mul: torch.Tensor, bias: torch.Tensor,
                            act: str = "none", alpha: float = 0.0,
                            scale: Optional[torch.Tensor] = None,
                            residual: Optional[torch.Tensor] = None,
                            store: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """Plain torch on any device: x [B, C, H, W] the conv's output; mean,
    mul (``rsqrt(var + eps) * weight``) and bias [C] fp32; ``scale`` [B];
    ``residual`` like x.  Returns a new tensor in ``store``."""
    if scale is not None:
        x = x * scale.to(x.dtype)[:, None, None, None]
    t = x.to(torch.float32) - mean[:, None, None]
    t.mul_(mul[:, None, None]).add_(bias[:, None, None])
    if act == "relu":
        F.relu(t, inplace=True)
    elif act == "relu6":
        torch.clamp_(t, 0.0, 6.0)
    elif act == "leaky_relu":
        F.leaky_relu(t, alpha, inplace=True)
    if residual is not None:
        t.add_(residual)
    return t.to(store)


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("conv_epilogue")
    lib.conv_epilogue.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_uint32] * 3
        + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int,
                                ctypes.c_void_p])
    lib.conv_epilogue.restype = ctypes.c_int
    lib.conv_epilogue_error_string.argtypes = [ctypes.c_int]
    lib.conv_epilogue_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
            bias: torch.Tensor, scale: Optional[torch.Tensor],
            residual: Optional[torch.Tensor], act: int, alpha: float,
            store: torch.dtype) -> torch.Tensor:
    """Run ``csrc/conv_epilogue.cu`` on the current stream (the CUDA
    implementation of ``torch.ops.k210.conv_epilogue``): x a dense 4-D
    NCHW or channels-last tensor in fp32 or bf16; the output in ``store``
    (fp32 or x's dtype) with x's strides."""
    if x.dim() != 4 or x.dtype not in _TYPES:
        raise ValueError(f"conv_epilogue: x must be a 4-D fp32 or bf16 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if store not in (torch.float32, x.dtype):
        raise ValueError(f"conv_epilogue: store must be float32 or x's "
                         f"{x.dtype}, got {store}")
    b, c, h, w = x.shape
    for name, t in (("mean", mean), ("mul", mul), ("bias", bias)):
        if t.device != x.device or t.dtype != torch.float32 \
                or tuple(t.shape) != (c,) or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous float32 [{c}] "
                             f"tensor on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if x.is_contiguous(memory_format=torch.channels_last):
        fmt, inner = torch.channels_last, 1
    elif x.is_contiguous():
        fmt, inner = torch.contiguous_format, h * w
    else:
        raise ValueError("conv_epilogue: x must be dense, NCHW or "
                         f"channels-last, got strides {x.stride()}")
    per_image = c * h * w
    if per_image >= 2 ** 32:
        raise ValueError(f"conv_epilogue: an image of {per_image} elements "
                         "does not index in 32 bits")
    if scale is not None:
        if tuple(scale.shape) != (b,) or scale.device != x.device:
            raise ValueError(f"scale: need [{b}] on {x.device}, got "
                             f"{tuple(scale.shape)} on {scale.device}")
        scale = scale.to(x.dtype).contiguous()
    if residual is not None:
        if residual.shape != x.shape or residual.device != x.device:
            raise ValueError(f"residual: need {tuple(x.shape)} on "
                             f"{x.device}, got {tuple(residual.shape)} on "
                             f"{residual.device}")
        residual = residual.to(torch.float32)
        if not residual.is_contiguous(memory_format=fmt):
            residual = residual.contiguous(memory_format=fmt)
    out = torch.empty_like(x, dtype=store)
    if out.numel() == 0:
        return out
    vector = inner == 1 and c % 8 == 0 and all(
        t is None or t.data_ptr() % 16 == 0
        for t in (x, out, residual, mean, mul, bias))
    layout = _CHANNELS_LAST if vector else _SCALAR
    lib = _kernel_lib()
    index = x.device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    args = (x.data_ptr(), _TYPES[x.dtype], out.data_ptr(), _TYPES[store],
            mean.data_ptr(), mul.data_ptr(), bias.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if residual is None else residual.data_ptr(), b, per_image,
            c, inner, layout, act, alpha, _sm_count(index), stream)
    if index == torch.cuda.current_device():
        err = lib.conv_epilogue(*args)
    else:
        with torch.cuda.device(x.device):
            err = lib.conv_epilogue(*args)
    if err != 0:
        raise RuntimeError("conv_epilogue kernel launch failed: "
                           + lib.conv_epilogue_error_string(err).decode())
    conv_epilogue.launches += 1
    return out


# A registered operator, so that the profiler records a host op around the
# launch and ties the kernel to it (a ctypes launch alone has none).
_LIB = torch.library.Library("k210", "DEF")
_LIB.define("conv_epilogue(Tensor x, Tensor mean, Tensor mul, Tensor bias, "
            "Tensor? scale, Tensor? residual, int act, float alpha, "
            "ScalarType store) -> Tensor")
_LIB.impl("conv_epilogue", _launch, "CUDA")


def conv_epilogue(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
                  bias: torch.Tensor, act: str = "none", alpha: float = 0.0,
                  scale: Optional[torch.Tensor] = None,
                  residual: Optional[torch.Tensor] = None,
                  store: torch.dtype = torch.float32) -> torch.Tensor:
    """The epilogue of ``conv_epilogue_reference`` (same arguments): CPU
    tensors through it, CUDA tensors through the kernel, counted in
    ``conv_epilogue.launches`` (one per call)."""
    if act not in ACTS:
        raise ValueError(f"conv_epilogue: act must be one of {ACTS}, got "
                         f"{act!r}")
    if x.device.type == "cpu":
        return conv_epilogue_reference(x, mean, mul, bias, act, alpha, scale,
                                       residual, store)
    if x.device.type != "cuda":
        raise ValueError(f"conv_epilogue: no kernel for device {x.device}")
    return torch.ops.k210.conv_epilogue(x, mean, mul, bias, scale, residual,
                                        ACTS.index(act), float(alpha), store)


conv_epilogue.launches = 0

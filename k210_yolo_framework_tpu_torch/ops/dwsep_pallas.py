"""Fused depthwise-separable block: dw3x3 -> folded BN -> ReLU -> pw1x1 ->
folded BN -> LeakyReLU, stride 1, SAME, eval mode.

Counterpart of ``k210_yolo_framework_tpu/ops/dwsep_pallas.py`` (``fold_bn``,
``fused_dwsep_reference``, ``fused_dwsep``).  As in the JAX package it is
held to its plain version and not wired into ``YoloMobileV1`` or
``Predictor``.  Tensors are NHWC, as the JAX functions take them.

``fused_dwsep`` dispatches by the device of its input: CPU tensors go
through ``fused_dwsep_reference``; CUDA tensors through the kernel
``csrc/dwsep.cu``, counted in ``fused_dwsep.launches``; any other device
raises.  There is no fallback from the kernel to the plain version.

The two compute the same block but round at different places, so they
agree within a tolerance, not bit for bit (fp32 rtol/atol 2e-5, bf16 0.05,
the tolerances of ``tests/test_dwsep_pallas.py``):

  * the plain version follows the JAX oracle: the depthwise conv with
    ``dw_k`` cast to x.dtype, its output rounded to x.dtype, then the folded
    BN in fp32;
  * the kernel follows the TPU kernel's body (``_kernel``): the 9 taps of
    x.dtype inputs times fp32 ``dw_k`` summed in fp32, then the folded BN,
    with one rounding to x.dtype after the ReLU.

Both take the pointwise product from x.dtype inputs with fp32 accumulation:
the kernel's bf16 instantiation on the tensor cores (``mma.sync``), its
fp32 one on CUDA cores.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from k210_yolo_framework_tpu_torch.ops import _build

__all__ = ["block_params", "fold_bn", "fused_dwsep", "fused_dwsep_reference"]


def fold_bn(scale, bias, mean, var, eps: float):
    """Eval-mode BatchNorm -> per-channel (mul, add): y = x * mul + add."""
    mul = scale / torch.sqrt(var + eps)
    return mul, bias - mean * mul


def block_params(block, eps: float = 1e-3):
    """A stride-1 ``models/mobilenet_v1._DWBlock`` as the arguments of
    ``fused_dwsep`` after x: (dw_k [3, 3, C], dw_mul, dw_add [C], pw_k
    [C, Cout], pw_mul, pw_add [Cout]), BN folded from its running
    statistics."""
    dw, pw = block.dw, block.pw
    if dw.conv.strides != (1, 1) or dw.conv.pads != ((1, 1), (1, 1)):
        raise ValueError("fused_dwsep takes stride-1 SAME blocks only")
    with torch.no_grad():
        dw_k = dw.conv.weight[:, 0].permute(1, 2, 0).contiguous()
        pw_k = pw.conv.weight[:, :, 0, 0].t().contiguous()
        dw_mul, dw_add = fold_bn(dw.bn.weight, dw.bn.bias,
                                 dw.bn.running_mean, dw.bn.running_var, eps)
        pw_mul, pw_add = fold_bn(pw.bn.weight, pw.bn.bias,
                                 pw.bn.running_mean, pw.bn.running_var, eps)
    return dw_k, dw_mul, dw_add, pw_k, pw_mul, pw_add


def fused_dwsep_reference(x, dw_k, dw_mul, dw_add, pw_k, pw_mul, pw_add,
                          pw_alpha: float = 0.3):
    """Plain-torch version on any device, the JAX oracle's arithmetic:
    x [B, H, W, C]; dw_k [3, 3, C]; pw_k [C, Cout]; folded BN [C] / [Cout].
    Returns [B, H, W, Cout] in x.dtype.

    Both products are taken in fp32 from values already rounded to x.dtype.
    A bf16 value is exact in TF32, so on a card the bf16 result does not
    depend on ``torch.backends.cudnn.allow_tf32``; an fp32 reference needs
    it off."""
    c = x.shape[-1]
    dt = x.dtype
    w = dw_k.to(dt).to(torch.float32).permute(2, 0, 1)[:, None]   # [C,1,3,3]
    t = F.conv2d(x.to(torch.float32).permute(0, 3, 1, 2), w, padding=1,
                 groups=c).permute(0, 2, 3, 1).to(dt)
    t = t.to(torch.float32) * dw_mul.to(torch.float32) \
        + dw_add.to(torch.float32)
    t = torch.clamp_min(t, 0.0).to(dt)
    o = torch.matmul(t.to(torch.float32), pw_k.to(dt).to(torch.float32))
    o = o * pw_mul.to(torch.float32) + pw_add.to(torch.float32)
    return torch.where(o > 0, o, pw_alpha * o).to(dt)


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("dwsep")
    lib.dwsep_forward.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_void_p] + [
        ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    lib.dwsep_forward.restype = ctypes.c_int
    lib.dwsep_error_string.argtypes = [ctypes.c_int]
    lib.dwsep_error_string.restype = ctypes.c_char_p
    lib.dwsep_max_dynamic_smem.argtypes = [ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_int)]
    lib.dwsep_max_dynamic_smem.restype = ctypes.c_int
    lib.dwsep_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.dwsep_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"dwsep {what} failed: "
                           + lib.dwsep_error_string(err).decode())


@functools.cache
def _max_channels(device: torch.device, is_bf16: bool) -> int:
    """Most input channels one block's shared memory holds on ``device``,
    by the kernel's own footprint (``dwsep_smem_bytes``: for bf16 the padded
    depthwise tile and the ring of pw_k chunks)."""
    lib = _kernel_lib()
    nbytes = ctypes.c_int(0)
    with torch.cuda.device(device):
        _check(lib, lib.dwsep_max_dynamic_smem(int(is_bf16),
                                               ctypes.byref(nbytes)),
               "shared-memory query")
    return _build.largest_fitting(
        lambda c: lib.dwsep_smem_bytes(int(is_bf16), c), nbytes.value)


_DTYPES = (torch.float32, torch.bfloat16)


def _launch(x, dw_k, dw_mul, dw_add, pw_k, pw_mul, pw_add, pw_alpha):
    """Run ``csrc/dwsep.cu`` on the current stream: x [B, H, W, C] float32
    or bfloat16, pw_k [C, Cout] in x.dtype, the rest float32; all
    contiguous, on x's device."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused_dwsep: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    b, h, w, c = x.shape
    cout = pw_k.shape[-1]
    want = {"x": (x, x.dtype, (b, h, w, c)),
            "dw_k": (dw_k, torch.float32, (3, 3, c)),
            "dw_mul": (dw_mul, torch.float32, (c,)),
            "dw_add": (dw_add, torch.float32, (c,)),
            "pw_k": (pw_k, x.dtype, (c, cout)),
            "pw_mul": (pw_mul, torch.float32, (cout,)),
            "pw_add": (pw_add, torch.float32, (cout,))}
    for name, (t, dtype, shape) in want.items():
        if t.device != x.device or t.dtype != dtype or not t.is_contiguous() \
                or tuple(t.shape) != shape:
            raise ValueError(f"{name}: need a contiguous {dtype} tensor of "
                             f"shape {shape} on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    is_bf16 = x.dtype == torch.bfloat16
    if c > _max_channels(x.device, is_bf16):
        raise ValueError(f"{c} input channels do not fit one block's shared "
                         f"memory; the kernel takes at most "
                         f"{_max_channels(x.device, is_bf16)} on {x.device}")
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dwsep_forward(
            x.data_ptr(), dw_k.data_ptr(), dw_mul.data_ptr(),
            dw_add.data_ptr(), pw_k.data_ptr(), pw_mul.data_ptr(),
            pw_add.data_ptr(), out.data_ptr(), b, h, w, c, cout,
            int(is_bf16), pw_alpha, stream)
    _check(lib, err, "kernel launch")
    fused_dwsep.launches += 1
    return out


def fused_dwsep(x, dw_k, dw_mul, dw_add, pw_k, pw_mul, pw_add,
                pw_alpha: float = 0.3):
    """Fused stride-1 SAME dw-separable block.

    x [B, H, W, C] (float32 or bfloat16 on a card); dw_k [3, 3, C];
    pw_k [C, Cout]; dw_mul / dw_add [C] and pw_mul / pw_add [Cout] the
    folded BNs.  Returns [B, H, W, Cout] in x.dtype.  CPU tensors go through
    ``fused_dwsep_reference``; CUDA tensors through the kernel, counted in
    ``fused_dwsep.launches``."""
    if x.device.type == "cpu":
        return fused_dwsep_reference(x, dw_k, dw_mul, dw_add, pw_k, pw_mul,
                                     pw_add, pw_alpha)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dwsep: no kernel for device {x.device}")
    f32 = [t.to(torch.float32).contiguous()
           for t in (dw_k, dw_mul, dw_add, pw_mul, pw_add)]
    return _launch(x.contiguous(), f32[0], f32[1], f32[2],
                   pw_k.to(x.dtype).contiguous(), f32[3], f32[4], pw_alpha)


fused_dwsep.launches = 0

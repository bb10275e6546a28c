"""Magnitude pruning inside the train step.

Counterpart of ``k210_yolo_framework_tpu/training/pruning.py``: a cubic
sparsity schedule, per-kernel magnitude masks recomputed every
``prune_frequency`` steps, and the masks multiplied into the weights after
every optimizer update, so that Adam cannot revive a pruned weight (its
moments are not masked, as in JAX).  The saved weights are already masked.

The functions work on tensors keyed by the net's parameter names; masks
exist only for prunable parameters.  A parameter is prunable where JAX's
``is_prunable`` selects its leaf: a conv ``kernel`` (dense, depthwise and
output convs), found through the native checkpoint names of
``training/checkpoint.py``.  BatchNorm scales and biases are not.

The threshold is ``jnp.quantile(|w|, s, method="linear")`` as XLA computes
it: sort, ``q = s * (n - 1)`` in fp32, the two neighbours ``lo`` and
``hi``, ``hw = q - floor(q)``, then ``hi * hw + lo * (1 - hw)``, which XLA
on the CPU evaluates as one fused multiply-add (the ``hi * hw`` product
unrounded).  The blend is written out here as that fused multiply-add,
computed exactly in float64 with round-to-odd, so that the card and the CPU
give the same threshold bit for bit.  ``torch.quantile`` is not used: its
``lerp`` rounds differently, and one ulp flips a weight that sits on the
threshold, since the mask keeps ``|w| >= thr``.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch
from torch import nn

from k210_yolo_framework_tpu_torch.training.checkpoint import native_key

__all__ = ["polynomial_sparsity", "is_prunable", "init_masks",
           "update_masks", "apply_masks", "sparsity_of"]


def polynomial_sparsity(step: int, initial: float, final: float,
                        begin_step: int, end_step: int,
                        power: int = 3) -> np.float32:
    """tfmot's PolynomialDecay in JAX's fp32 arithmetic:
    ``final + (initial - final) * (1 - p)^power`` with
    ``p = clip((step - begin) / max(end - begin, 1), 0, 1)``.  ``step`` is
    the host's step count, so no device value is read."""
    f32 = np.float32
    span = max(end_step - begin_step, 1)
    p = (f32(step) - f32(begin_step)) / f32(span)
    p = min(max(p, f32(0.0)), f32(1.0))
    x, acc, y = f32(1.0) - p, None, power
    while y > 0:              # lax.integer_pow: binary exponentiation
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    acc = f32(1.0) if acc is None else acc
    return f32(final) + f32(initial - final) * acc


def is_prunable(name: str, param: torch.Tensor) -> bool:
    """True for a conv kernel: JAX's leaf named ``kernel`` of rank 2 or 4."""
    leaf = native_key(name, param.ndim).rsplit("/", 1)[-1]
    return leaf == "kernel" and param.ndim in (2, 4)


def init_masks(net: nn.Module) -> Dict[str, torch.Tensor]:
    """All-ones masks over the prunable parameters."""
    return {n: torch.ones_like(p, requires_grad=False)
            for n, p in net.named_parameters() if is_prunable(n, p)}


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
             ) -> torch.Tensor:
    """fp32 ``a * b + c`` rounded once, for fp32 tensors: the product is
    exact in float64, the sum is made exact by TwoSum and rounded to odd,
    and float64 -> fp32 then rounds to nearest correctly (53 >= 24 + 2)."""
    x = a.double() * b.double()
    y = c.double()
    s = x + y
    bb = s - x
    err = (x - (s - bb)) + (y - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without a host-device sync: a copy from
    pageable memory waits for the stream's queued work, so a CUDA copy goes
    through pinned memory, asynchronously."""
    t = torch.from_numpy(a)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _thresholds(sorted_mags: List[torch.Tensor], q: np.float32
                ) -> torch.Tensor:
    """``jnp.quantile(x, q)`` of each sorted fp32 vector -> [K] fp32; NaN
    where the vector holds a NaN (sorted last)."""
    f32 = np.float32
    lo_i, hi_i, last_i, lw, hw = [], [], [], [], []
    off = 0
    for s in sorted_mags:
        n = f32(s.numel())
        qn = f32(q) * (n - f32(1.0))
        low, high = np.floor(qn), np.ceil(qn)
        h = f32(qn - low)
        hw.append(h)
        lw.append(f32(1.0) - h)
        lo_i.append(off + int(min(max(low, f32(0.0)), n - f32(1.0))))
        hi_i.append(off + int(min(max(high, f32(0.0)), n - f32(1.0))))
        last_i.append(off + s.numel() - 1)
        off += s.numel()
    dev = sorted_mags[0].device
    flat = torch.cat(sorted_mags)
    idx = _to_device(np.asarray(lo_i + hi_i + last_i, np.int64), dev)
    lo_v, hi_v, last_v = flat[idx].view(3, -1)
    lw_t, hw_t = _to_device(np.asarray(lw + hw, np.float32), dev).view(2, -1)
    thr = _fma_f32(hi_v, hw_t, lo_v * lw_t)
    return torch.where(torch.isnan(last_v), last_v, thr)


@torch.no_grad()
def update_masks(params: Mapping[str, torch.Tensor],
                 masks: Mapping[str, torch.Tensor],
                 sparsity: float) -> Dict[str, torch.Tensor]:
    """New masks for the parameters ``masks`` names: each keeps the weights
    whose magnitude is at least its kernel's ``sparsity`` quantile
    (``sparsity`` clipped to [0, 1] in fp32)."""
    names = list(masks)
    if not names:
        return {}
    q = np.clip(np.float32(sparsity), np.float32(0.0), np.float32(1.0))
    mags = torch._foreach_abs([params[n].detach() for n in names])
    thr = _thresholds([torch.sort(m.reshape(-1)).values for m in mags], q)
    return {n: (m >= thr[i]).to(params[n].dtype)
            for i, (n, m) in enumerate(zip(names, mags))}


@torch.no_grad()
def apply_masks(params: Mapping[str, torch.Tensor],
                masks: Mapping[str, torch.Tensor]) -> None:
    """Multiply each masked parameter by its mask, in place (one
    multi-tensor launch per group of tensors)."""
    if masks:
        torch._foreach_mul_([params[n] for n in masks], list(masks.values()))


def sparsity_of(masks: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The share of masked-out weights over all masked parameters, as JAX
    sums it (fp32, one kernel after another); a 0-d tensor on the masks'
    device."""
    zeros, total = None, np.float32(0.0)
    for m in masks.values():
        z = (1.0 - m).sum(dtype=torch.float32)
        zeros = z if zeros is None else zeros + z
        total = total + np.float32(m.numel())
    if zeros is None:
        return torch.zeros(())
    # a divisor on the device (a fill, no copy that would sync): CUDA
    # divides by a CPU scalar as a product with its reciprocal, an ulp
    # from the quotient at times
    return zeros / torch.full((), max(float(total), 1.0),
                              dtype=torch.float32, device=zeros.device)

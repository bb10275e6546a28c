"""Weights carried between the JAX package's native checkpoint layout and
a torch ``state_dict``.

The native ``.h5`` (``k210_yolo_framework_tpu/training/checkpoint.py:
save_h5``) stores ``params/<scope>/kernel`` (HWIO), ``params/<scope>/bias``,
``params/<scope>/bn/scale`` and ``batch_stats/<scope>/bn/{mean,var}``.  The
port's modules are named after the flax scopes, so the map is mechanical:

    params/<a>/<b>/kernel   [kh, kw, I, O]  <->  <a>.<b>.weight  [O, I, kh, kw]
    params/<a>/bn/scale                     <->  <a>.bn.weight
    params/<a>/bias                         <->  <a>.bias
    batch_stats/<a>/bn/mean                 <->  <a>.bn.running_mean
    batch_stats/<a>/bn/var                  <->  <a>.bn.running_var

A depthwise kernel ``[kh, kw, 1, C]`` becomes ``[C, 1, kh, kw]`` by the same
permutation.  ``flat`` dicts hold numpy arrays keyed by the full path.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

__all__ = ["state_dict_from_flat", "flat_from_state_dict", "load_h5",
           "load_npz"]

_TO_TORCH = {("params", "kernel"): "weight", ("params", "scale"): "weight",
             ("params", "bias"): "bias",
             ("batch_stats", "mean"): "running_mean",
             ("batch_stats", "var"): "running_var"}
_HWIO_TO_OIHW = (3, 2, 0, 1)
_OIHW_TO_HWIO = (2, 3, 1, 0)


def _check_against(sd: Mapping[str, torch.Tensor], net: nn.Module) -> None:
    want = net.state_dict()
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    if missing or extra:
        raise KeyError(f"checkpoint does not fit the net: missing {missing}, "
                       f"unexpected {extra}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(f"{k}: checkpoint shape {tuple(v.shape)} != "
                             f"net shape {tuple(want[k].shape)}")


def state_dict_from_flat(flat: Mapping[str, np.ndarray],
                         net: Optional[nn.Module] = None
                         ) -> "OrderedDict[str, torch.Tensor]":
    """Native-layout arrays -> a torch state dict.  With ``net`` given, a
    missing or extra key or a shape mismatch raises."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for key in sorted(flat):
        group, *scope, leaf = key.split("/")
        name = _TO_TORCH.get((group, leaf))
        if name is None or not scope:
            raise KeyError(f"{key}: not a native checkpoint leaf")
        t = torch.from_numpy(np.array(flat[key], dtype=np.float32))
        if leaf == "kernel":
            if t.ndim != 4:
                raise ValueError(f"{key}: kernel of shape {tuple(t.shape)}")
            t = t.permute(*_HWIO_TO_OIHW).contiguous()
        sd[".".join(scope + [name])] = t
    if net is not None:
        _check_against(sd, net)
    return sd


def flat_from_state_dict(sd: Mapping[str, torch.Tensor]
                         ) -> Dict[str, np.ndarray]:
    """The exact inverse of :func:`state_dict_from_flat`."""
    flat = {}
    for name, t in sd.items():
        *scope, leaf = name.split(".")
        t = t.detach().to("cpu", torch.float32)
        if leaf == "weight" and t.ndim == 4:
            key, t = ("params", "kernel"), t.permute(*_OIHW_TO_HWIO)
        elif leaf == "weight":
            key = ("params", "scale")
        elif leaf == "bias":
            key = ("params", "bias")
        elif leaf == "running_mean":
            key = ("batch_stats", "mean")
        elif leaf == "running_var":
            key = ("batch_stats", "var")
        else:
            raise KeyError(f"{name}: no native checkpoint counterpart")
        flat["/".join([key[0], *scope, key[1]])] = t.contiguous().numpy()
    return flat


def load_h5(path: str, net: nn.Module) -> "OrderedDict[str, torch.Tensor]":
    """A native ``.h5`` (``params`` / ``batch_stats`` groups) -> a state
    dict checked against ``net``."""
    import h5py

    flat = {}

    def collect(group):
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                flat[f"{group}/{name}"] = obj[()]
        return visit

    with h5py.File(path, "r") as f:
        for group in ("params", "batch_stats"):
            if group in f:
                f[group].visititems(collect(group))
    if not flat:
        raise ValueError(f"{path}: no native params/batch_stats groups")
    return state_dict_from_flat(flat, net)


def load_npz(path: str, net: nn.Module) -> "OrderedDict[str, torch.Tensor]":
    """An ``.npz`` keyed by the native paths -> a state dict checked against
    ``net``."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return state_dict_from_flat(flat, net)

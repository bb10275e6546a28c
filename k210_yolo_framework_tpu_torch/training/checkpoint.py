"""Checkpoints: the weight bridge between the JAX package's native layout
and a torch ``state_dict``, the native ``.h5`` and its ``.npz`` twin, the
train state, and ``args.txt``.

Counterpart of ``k210_yolo_framework_tpu/training/checkpoint.py``.  Where
JAX keeps the train state in an orbax directory, the port keeps it in a
directory holding one ``torch.save`` file (:func:`save_state`); orbax
cannot be read without orbax, so :func:`load_variables` names the way
across instead (the JAX package's ``save_h5``, then this module's
``load_variables``).  ``h5py`` is imported by the functions that need it.

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

The calibrated activation ranges of the int8-activation modes (JAX's
``act_ranges`` collection) are buffers outside the state dict and cross by
:func:`load_act_ranges` / :func:`act_ranges_flat`:

    act_ranges/<a>/conv/min  <->  <a>.conv.act_min   (and max)
"""

from __future__ import annotations

import os
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

__all__ = ["native_key", "state_dict_from_flat", "flat_from_state_dict",
           "load_act_ranges", "act_ranges_flat", "load_h5", "load_npz", "save_h5", "save_npz", "save_state",
           "restore_state", "load_variables", "write_args_txt"]

STATE_FILE = "train_state.pt"
# what an orbax checkpoint directory holds at its top level
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")

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


def native_key(name: str, ndim: int) -> str:
    """The native checkpoint path of the state-dict entry ``name`` of rank
    ``ndim`` (``backbone.stem.conv.weight``, 4 ->
    ``params/backbone/stem/conv/kernel``)."""
    *scope, leaf = name.split(".")
    if leaf == "weight" and ndim == 4:
        key = ("params", "kernel")
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
    return "/".join([key[0], *scope, key[1]])


def flat_from_state_dict(sd: Mapping[str, torch.Tensor]
                         ) -> Dict[str, np.ndarray]:
    """The exact inverse of :func:`state_dict_from_flat`."""
    flat = {}
    for name, t in sd.items():
        t = t.detach().to("cpu", torch.float32)
        key = native_key(name, t.ndim)
        if key.endswith("/kernel"):
            t = t.permute(*_OIHW_TO_HWIO)
        flat[key] = t.contiguous().numpy()
    return flat


def load_act_ranges(net: nn.Module, flat: Mapping[str, np.ndarray]) -> None:
    """Set each conv's ``act_min`` / ``act_max`` from ``act_ranges/...``
    entries of ``flat`` (other groups are ignored); a path that is not an
    int8-capable conv of ``net`` raises ``KeyError``."""
    convs = dict(net.named_modules())
    for key, value in flat.items():
        group, *scope, leaf = key.split("/")
        if group != "act_ranges":
            continue
        conv = convs.get(".".join(scope))
        if leaf not in ("min", "max") or not getattr(conv, "int8_capable",
                                                     False):
            raise KeyError(f"{key}: no int8 conv of the net holds it")
        buf = conv.act_ranges(conv.weight.device)[leaf == "max"]
        with torch.no_grad():
            buf.copy_(torch.from_numpy(np.array(value, np.float32)))


def act_ranges_flat(net: nn.Module) -> Dict[str, np.ndarray]:
    """The inverse of :func:`load_act_ranges`: every conv holding ranges."""
    flat = {}
    for name, mod in net.named_modules():
        if hasattr(mod, "act_min"):
            path = "/".join(["act_ranges", *name.split(".")])
            flat[f"{path}/min"] = mod.act_min.detach().cpu().numpy()
            flat[f"{path}/max"] = mod.act_max.detach().cpu().numpy()
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


def save_h5(path: str, net: nn.Module) -> None:
    """The net's weights as a native ``.h5`` (``params/<scope>/kernel``,
    ``batch_stats/<scope>/bn/mean`` and so on, fp32, kernels HWIO): the file
    the JAX package's ``save_h5`` writes and its ``load_h5`` reads."""
    import h5py

    flat = flat_from_state_dict(net.state_dict())
    with h5py.File(path, "w") as f:
        for group in ("params", "batch_stats"):
            g = f.create_group(group)
            for key in sorted(k for k in flat if k.startswith(group + "/")):
                g.create_dataset(key[len(group) + 1:], data=flat[key])


def save_npz(path: str, net: nn.Module) -> None:
    """The twin of :func:`save_h5` as an ``.npz`` with the same keys (for a
    machine without h5py); :func:`load_npz` reads it."""
    np.savez(path, **flat_from_state_dict(net.state_dict()))


def _to_cpu(obj):
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_state(path: str, state) -> None:
    """The whole train state (``training.train.TrainState``) in the
    directory ``path``: one ``torch.save`` file holding the net's state
    dict, the optimizer's, the step count, the P/R counters and the pruning
    masks, every tensor on the CPU.  Written to a temporary name, then
    renamed."""
    d = Path(path)
    d.mkdir(parents=True, exist_ok=True)
    payload = {"net": _to_cpu(state.net.state_dict()),
               "optimizer": _to_cpu(state.optimizer.state_dict()),
               "step": int(state.step), "pr": _to_cpu(state.pr),
               "masks": _to_cpu(state.masks)}
    tmp = d / (STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, d / STATE_FILE)


def _load_payload(path: str) -> dict:
    d = Path(path)
    if (d / STATE_FILE).is_file():
        return torch.load(d / STATE_FILE, map_location="cpu",
                          weights_only=True)
    if any((d / m).exists() for m in _ORBAX_MARKERS):
        raise ValueError(
            f"{path}: an orbax train-state directory (the JAX package's "
            "save_state), which the port cannot read without orbax; write "
            "its weights with the JAX package's training.checkpoint.save_h5 "
            "and load that .h5 with this module's load_variables")
    raise ValueError(f"{path}: not a train-state directory (no "
                     f"{STATE_FILE}) and not an orbax checkpoint")


def restore_state(path: str, state):
    """Load a :func:`save_state` directory into ``state`` (a TrainState
    built for the same net and optimizer) in place and return it: weights
    and BN statistics, optimizer moments, step count and P/R counters.  A
    pruning state takes the saved masks (all ones where the saved run did
    not prune); a state that does not prune ignores them."""
    payload = _load_payload(path)
    _check_against(payload["net"], state.net)
    state.net.load_state_dict(payload["net"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    device = next(state.net.parameters()).device
    state.pr = {k: v.to(device) for k, v in payload["pr"].items()}
    if state.masks:
        from k210_yolo_framework_tpu_torch.training import pruning

        saved = payload["masks"]
        if saved:
            if sorted(saved) != sorted(state.masks):
                raise KeyError(f"{path}: masks for {sorted(saved)}, the net "
                               f"prunes {sorted(state.masks)}")
            # empty_like keeps each mask's device and memory format
            state.masks = {k: torch.empty_like(m).copy_(saved[k])
                           for k, m in state.masks.items()}
        state.sparsity = pruning.sparsity_of(state.masks)
    return state


def load_variables(path: str, model_def: str, net: nn.Module
                   ) -> "OrderedDict[str, torch.Tensor]":
    """One checkpoint load for the entry points -> a state dict checked
    against ``net``.  ``path`` may be a native ``.h5`` (``params`` /
    ``batch_stats`` groups), an ``.npz`` of the same keys, a reference
    Keras ``.h5`` (``model_weights`` layout, through
    ``port.port_reference_h5`` for ``model_def``; layers the file lacks stay
    at ``net``'s values and are named) or a :func:`save_state` directory.
    An orbax directory written by the JAX package, and an ``.h5`` holding
    no layer of ``model_def``'s reference map, raise ``ValueError``."""
    p = Path(path)
    if p.is_dir():
        sd = OrderedDict(_load_payload(path)["net"])
        _check_against(sd, net)
        return sd
    if p.suffix == ".npz":
        return load_npz(path, net)
    if p.suffix == ".h5":
        import h5py

        with h5py.File(path, "r") as f:
            is_native = "params" in f
            top_keys = list(f.keys())[:8]
        if is_native:
            return load_h5(path, net)
        from k210_yolo_framework_tpu_torch.port import _table, port_reference_h5
        from k210_yolo_framework_tpu_torch.utils.console import NOTE

        flat, missing = port_reference_h5(
            path, model_def, flat_from_state_dict(net.state_dict()))
        if len(missing) == len(_table(model_def)):
            raise ValueError(
                f"{path}: no layer of the {model_def} reference map "
                f"(top-level keys {top_keys})")
        if missing:
            print(NOTE, f"ported reference Keras weights from {path} "
                  f"({len(missing)} layers absent, left as they were: "
                  f"{missing[:4]}...)")
        return state_dict_from_flat(flat, net)
    raise ValueError(f"{path}: not a checkpoint the port reads (a native "
                     ".h5, an .npz, a reference Keras .h5 or a save_state "
                     "directory)")


def write_args_txt(args: Mapping[str, object], path: str) -> None:
    """``key: value`` per line, as the JAX package writes it."""
    with open(path, "w") as f:
        for k, v in args.items():
            f.write(f"{k}: {v}\n")

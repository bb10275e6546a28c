"""The bytes of the conv epilogue's work in one serving call, counted on the
reference net (``reference/nets.py`` or its builder file) on the ``meta``
device, whatever implements the work: each eval ConvBN reads its conv's
output once in the configuration's precision; one whose output is the
fresh addend of a residual sum reads that sum's other addend once in fp32;
and it writes its output once in the width the net stores, fp32 where the
output is an addend of a residual sum (the sum stays fp32), the
configuration's precision otherwise.  The residual sums are found as the
reference computes them: an add of two tensors of one shape, at least one
of them a ConvBN's output, or such a sum (which the program writes into
the fresh ConvBN's output)."""

from __future__ import annotations

import functools
import json

import torch
from torch.overrides import TorchFunctionMode

_ADDS = (torch.Tensor.__add__, torch.Tensor.__radd__, torch.Tensor.add,
         torch.add)


class _Adds(TorchFunctionMode):
    """Sees every add; ``outputs`` maps id(tensor) -> the ConvBN record
    whose stored output that tensor is."""

    def __init__(self, outputs: dict, keep: list):
        super().__init__()
        self.outputs, self.keep = outputs, keep

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _ADDS and len(args) == 2 and all(
                isinstance(a, torch.Tensor) for a in args) \
                and args[0].shape == args[1].shape:
            recs = [self.outputs.get(id(a)) for a in args]
            if any(r is not None for r in recs):
                for r in recs:
                    if r is not None:
                        r["wide"] = True
                fresh = max((r for r in recs if r is not None),
                            key=lambda r: r["order"])
                fresh["residual"] = True
                self.outputs[id(out)] = fresh
                self.keep.append(out)
        return out


def _records(cfg: dict) -> list:
    from yolo_bench.counts import _net
    from yolo_bench.reference import nets as RN

    net = _net(cfg)
    records, outputs, keep = [], {}, []

    def hook(_mod, _args, out):
        rec = {"numel": out.numel(), "order": len(records), "wide": False,
               "residual": False}
        records.append(rec)
        outputs[id(out)] = rec
        keep.append(out)

    for m in net.modules():
        if isinstance(m, RN.ConvBN):
            m.register_forward_hook(hook)
    x = torch.zeros((1, *cfg["in_hw"], 3), device="meta")
    with _Adds(outputs, keep):
        RN.forward(net, x, cfg["anchors_per_layer"])
    return records


@functools.lru_cache(maxsize=None)
def _per_image(cfg_json: str) -> int:
    cfg = json.loads(cfg_json)
    narrow = torch.empty((), dtype=getattr(torch, cfg["precision"]),
                         device="meta").element_size()
    total = 0
    for r in _records(cfg):
        per = narrow + (4 if r["wide"] else narrow) + (
            4 if r["residual"] else 0)
        total += r["numel"] * per
    return total


def epilogue_bytes(cfg: dict, images: int) -> int:
    """Bytes of one call over ``images`` images of the configuration."""
    return images * _per_image(json.dumps(cfg, sort_keys=True))

"""The weights a cell serves or trains, made on the device from the seed.

Every tensor comes from a few large draws of a ``torch.Generator`` on the
run's device, in fp32 (the program holds fp32 parameters and casts them to
its compute dtype in each conv):

* conv kernels: flax's lecun normal, a normal of std sqrt(1 / fan_in) /
  0.8796 truncated at two standard deviations (here clamped there);
* BatchNorm scale U(0.4, 0.6) and shift N(0.5, 0.25^2) per channel: most
  units sit on the linear side of their activation, as in trained nets.
  Scale 1 and shift 0 make a random net chaotic under BatchNorm (each
  layer's centring leaves a perturbation larger against the signal than
  before): a bf16 rounding then moves its logits by 10-14% of their spread
  and an int8 one decorrelates them, where with these they move by 1-2%
  and 5-10% (the reference in those precisions, on the CPU);
* the output convs' weights and biases set, over the cell's first images
  (serving; biases 0 for training), every output channel's mean to 0 and
  its spread to ``box_logit_std`` (box entries) or ``score_logit_std``
  (objectness and classes: a trained detector's scores spread from near 0
  to near 1), then objectness shifted by ``conf_bias``: how many
  candidates clear the threshold is then the same for every seed;
* BatchNorm's running statistics, for serving, those of the reference net's
  own activations over the cell's first images (``calibrate``), as a
  trained net's statistics match its activations; a net that normalised
  by made-up statistics would blow its activations up or shrink them to
  nothing over its depth, and its detections would not depend on the image.
  For training they start at mean 0 and variance 1 (a train step
  normalises by the batch).

The names and shapes are the reference net's, which are the program's
state dict's keys; the program loads the result with ``strict=True``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from yolo_bench.reference import nets as RN
from yolo_bench.reference import serve as RS

TRUNC = 0.87962566103423978


def make_state(net: torch.nn.Module, cfg: dict, seed: int,
               device: torch.device) -> None:
    """Fill ``net`` (a reference net on ``device``) from ``seed``, in
    place."""
    gen = torch.Generator(device=device).manual_seed(seed)
    convs = RN.conv_layers(net)
    bns = RN.bn_layers(net)
    with torch.no_grad():
        total = sum(c.weight.numel() for _, c in convs)
        flat = torch.randn(total, generator=gen, device=device)
        flat.clamp_(-2.0, 2.0)
        at = 0
        for _, c in convs:
            n = c.weight.numel()
            fan_in = c.weight[0].numel()
            c.weight.copy_(flat[at:at + n].view_as(c.weight)
                           * (math.sqrt(1.0 / fan_in) / TRUNC))
            at += n
            if c.bias is not None:
                c.bias.zero_()
        chans = sum(b.weight.numel() for _, b in bns)
        draws = torch.rand(2, chans, generator=gen, device=device)
        at = 0
        for _, b in bns:
            n = b.weight.numel()
            b.weight.copy_(0.4 + 0.2 * draws[0, at:at + n])
            # a normal from a uniform, by the inverse CDF
            b.bias.copy_(0.5 + 0.25 * math.sqrt(2.0) * torch.erfinv(
                2.0 * draws[1, at:at + n].clamp(1e-6, 1 - 1e-6) - 1.0))
            b.running_mean.zero_()
            b.running_var.fill_(1.0)
            at += n


def state_of(net: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A copy of the net's tensors by name: the state dict both sides
    load."""
    return {k: v.detach().clone() for k, v in RN.tensors(net).items()}


@torch.no_grad()
def calibrate(net: torch.nn.Module, cfg: dict, canvases: torch.Tensor,
              img_hws: torch.Tensor) -> None:
    """Set every BatchNorm's running statistics to those of its input over
    these images, letterboxed and scaled to [0, 1] by the reference, then
    each output conv's bias to centre its channels there (plus
    ``conf_bias`` on objectness).  The output convs are the net's convs
    with a bias, in the order the net registers them, which is the order
    of its outputs (``nets.builder_file``)."""
    RN.ensure_fp32()
    images = RS.unit_scale(RS.letterbox(canvases, img_hws, cfg["in_hw"]))
    na = cfg["anchors_per_layer"]
    RN.forward(net, images, na, RN.Ctx("calibrate"))
    outs = RN.forward(net, images, na)
    heads = [m for _, m in RN.conv_layers(net) if m.bias is not None]
    if len(heads) != len(outs):
        raise ValueError(f"{cfg['model_def']}: {len(heads)} convs with a "
                         f"bias, {len(outs)} outputs")
    step = 5 + cfg["classes"]
    w = cfg["weights"]
    target = torch.full((step,), float(w["box_logit_std"]),
                        device=canvases.device)
    target[4:] = float(w["score_logit_std"])
    target = target.repeat(na)
    for conv, out in zip(heads, outs):
        flat = out.reshape(-1, out.shape[-2] * out.shape[-1])
        gain = target / flat.std(0).clamp_min(1e-6)
        conv.bias.sub_(flat.mean(0)).mul_(gain)
        conv.weight.mul_(gain[:, None, None, None])
        conv.bias[4::step] += float(cfg["weights"]["conf_bias"])

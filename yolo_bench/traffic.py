"""The one traffic generator: a cell's inputs from its traffic file and the
seed.

A traffic file (``yolo_bench/traffic/<name>.json``) gives the entry kind
that drives it and these parameters:

* ``batch``: images a call; ``pool``: distinct batches made, which the
  window's calls cycle through;
* ``canvas_hw``: the staging canvas each image sits in, top-left, zeros
  elsewhere; ``image_hws``: the image sizes, dealt out in turn over the
  pool's images and then shuffled by the seed, so every seed serves the
  same sizes in another order;
* pixels are uniform 0..255 inside each image;
* ``boxes_per_image`` ground-truth boxes in ``box_slots`` padded slots,
  class uniform over ``classes``, centre U(``box_xy``) and size
  U(``box_wh``) of the image, where the entry trains;
* the entry's own settings (thresholds, ``max_out``) pass through.

Everything is drawn on the run's device by a ``torch.Generator`` seeded
with the seed; the same seed gives the same inputs on the same device.
"""

from __future__ import annotations

from typing import Dict

import torch


def make(traffic: dict, seed: int, device: torch.device,
         stream: int = 1) -> Dict[str, torch.Tensor]:
    """{"canvases" [P, B, H, W, 3] uint8, "img_hws" [P, B, 2] int32, and
    with boxes "boxes" [P, B, slots, 5] fp32 (class, x, y, w, h),
    "valid" [P, B, slots] bool}, on ``device``.  ``stream`` separates this
    draw from the weights' draw of the same seed."""
    gen = torch.Generator(device=device).manual_seed(seed * 8 + stream)
    p, b = int(traffic["pool"]), int(traffic["batch"])
    ch, cw = traffic["canvas_hw"]
    sizes = torch.tensor(traffic["image_hws"], dtype=torch.int32,
                         device=device)
    dealt = sizes[torch.arange(p * b, device=device) % len(sizes)]
    order = torch.randperm(p * b, generator=gen, device=device)
    hws = dealt[order].view(p, b, 2)
    canv = torch.randint(0, 256, (p, b, ch, cw, 3), generator=gen,
                         device=device, dtype=torch.uint8)
    rows = torch.arange(ch, device=device).view(1, 1, ch, 1)
    cols = torch.arange(cw, device=device).view(1, 1, 1, cw)
    inside = (rows < hws[..., 0, None, None]) & (cols < hws[..., 1, None,
                                                                  None])
    canv.mul_(inside[..., None].to(torch.uint8))
    out = {"canvases": canv, "img_hws": hws}
    if "boxes_per_image" in traffic:
        slots, n = int(traffic["box_slots"]), int(traffic["boxes_per_image"])
        u = torch.rand(p, b, slots, 5, generator=gen, device=device)
        (xlo, xhi), (wlo, whi) = traffic["box_xy"], traffic["box_wh"]
        boxes = torch.cat([
            torch.floor(u[..., :1] * traffic["classes"]),
            xlo + (xhi - xlo) * u[..., 1:3],
            wlo + (whi - wlo) * u[..., 3:5]], -1)
        valid = torch.arange(slots, device=device).expand(p, b, slots) < n
        out["boxes"] = boxes * valid[..., None]
        out["valid"] = valid
    return out

"""YOLOv4 in plain fp32 PyTorch, written from darknet's ``cfg/yolov4.cfg``:
its layer list, run the way darknet runs a cfg, and darknet's decode with
``scale_x_y``.  Imports no JAX and nothing of the port; holds the port's
``YoloV4`` to account in ``tests/test_torch_yolov4.py``.

``LAYERS`` is the cfg's 162 layers in its order, each a dict: ``conv``
(filters, size, stride, activation ``mish`` / ``leaky`` / ``linear``, a
``linear`` one with a bias and no BatchNorm), ``route`` (``layers``: its
absolute or relative indices, concatenated on channels in that order),
``shortcut`` (``from``: the layer added to the previous one), ``maxpool``
(stride 1, ``size`` 5, 9 or 13), ``upsample`` (stride 2) and ``yolo``
(``mask`` and ``scale_x_y``).  It is generated by loops, which the cfg's
own layer numbers (the routes ``85`` and ``54``; ``-16`` and ``-37``) and
the counts in :func:`check_layers` pin.

Running it: a conv pads ``size // 2`` on every side (darknet's ``pad=1``),
BatchNorm normalises with its running statistics, or with the batch's
while ``calibrate`` sets them; the output of every ``yolo`` layer is kept,
and :func:`forward` returns them coarsest grid first (the cfg's reverse
order).  The BatchNorm epsilon is the framework's, 1e-3 (keras), not
darknet's 1e-5: the weights the tests draw are the framework's.

``weights`` is one entry a conv, in the cfg's order: ``{"w", "gamma",
"beta", "mean", "var"}``, or ``{"w", "b"}`` for a linear conv.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-3
# the cfg's anchors, in input pixels, and its [yolo] layers' masks
ANCHORS = ((12, 16), (19, 36), (40, 28), (36, 75), (76, 55), (72, 146),
           (142, 110), (192, 243), (459, 401))


def _conv(filters, size, act="mish", stride=1):
    return {"type": "conv", "filters": filters, "size": size,
            "stride": stride, "act": act}


def _csp_stage(filters, units, first):
    """One downsampling CSP block of the cfg: conv 3x3/2, the A conv,
    ``route -2``, the B conv, the units (1x1, 3x3, ``shortcut -3``), the
    1x1 after them, ``route -1,-(units*3 + 4)`` and the transition."""
    half = filters if first else filters // 2
    inner = filters // 2 if first else half
    out = [_conv(filters, 3, stride=2), _conv(half, 1),
           {"type": "route", "layers": [-2]}, _conv(half, 1)]
    for _ in range(units):
        out += [_conv(inner, 1), _conv(half, 3),
                {"type": "shortcut", "from": -3}]
    out += [_conv(half, 1),
            {"type": "route", "layers": [-1, -(3 * units + 4)]},
            _conv(filters, 1)]
    return out


def _stack(filters, n):
    return [_conv(filters if i % 2 == 0 else 2 * filters,
                  1 if i % 2 == 0 else 3, "leaky") for i in range(n)]


def _layers() -> List[dict]:
    out = [_conv(32, 3)]
    for filters, units in ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4)):
        out += _csp_stage(filters, units, first=filters == 64)
    out += _stack(512, 3)                                      # 105-107
    out += [{"type": "maxpool", "size": 5},                    # 108
            {"type": "route", "layers": [-2]},
            {"type": "maxpool", "size": 9},                    # 110
            {"type": "route", "layers": [-4]},
            {"type": "maxpool", "size": 13},                   # 112
            {"type": "route", "layers": [-1, -3, -5, -6]}]     # 113
    out += _stack(512, 3)                                      # 114-116
    out += [_conv(256, 1, "leaky"), {"type": "upsample"},      # 117-118
            {"type": "route", "layers": [85]}, _conv(256, 1, "leaky"),
            {"type": "route", "layers": [-1, -3]}]             # 121
    out += _stack(256, 5)                                      # 122-126
    out += [_conv(128, 1, "leaky"), {"type": "upsample"},      # 127-128
            {"type": "route", "layers": [54]}, _conv(128, 1, "leaky"),
            {"type": "route", "layers": [-1, -3]}]             # 131
    out += _stack(128, 5)                                      # 132-136
    out += [_conv(256, 3, "leaky"), _conv(None, 1, "linear"),  # 137-138
            {"type": "yolo", "mask": (0, 1, 2), "scale_x_y": 1.2},
            {"type": "route", "layers": [-4]},
            _conv(256, 3, "leaky", stride=2),                  # 141
            {"type": "route", "layers": [-1, -16]}]
    out += _stack(256, 5)                                      # 143-147
    out += [_conv(512, 3, "leaky"), _conv(None, 1, "linear"),  # 148-149
            {"type": "yolo", "mask": (3, 4, 5), "scale_x_y": 1.1},
            {"type": "route", "layers": [-4]},
            _conv(512, 3, "leaky", stride=2),                  # 152
            {"type": "route", "layers": [-1, -37]}]
    out += _stack(512, 5)                                      # 154-158
    out += [_conv(1024, 3, "leaky"), _conv(None, 1, "linear"),  # 159-160
            {"type": "yolo", "mask": (6, 7, 8), "scale_x_y": 1.05}]
    return out


LAYERS = _layers()


def check_layers() -> None:
    """The cfg's counts: 162 layers, 110 convs (72 Mish, 35 leaky, 3
    linear), the three [yolo] layers at 139, 150 and 161, and the routes
    to the stage-4 and stage-3 outputs at 85 and 54 landing on the
    transitions of those stages."""
    convs = [l for l in LAYERS if l["type"] == "conv"]
    assert len(LAYERS) == 162 and len(convs) == 110
    assert [sum(c["act"] == a for c in convs)
            for a in ("mish", "leaky", "linear")] == [72, 35, 3]
    assert [i for i, l in enumerate(LAYERS) if l["type"] == "yolo"] == [
        139, 150, 161]
    for i, f in ((85, 512), (54, 256), (104, 1024)):
        assert LAYERS[i]["type"] == "conv" and LAYERS[i]["filters"] == f
        assert LAYERS[i - 1]["type"] == "route"


def conv_shapes(classes: int, anchors: int = 3) -> List[tuple]:
    """(out, in, k, k) of each conv in the cfg's order, for 3 input
    channels."""
    shapes, chans = [], []
    c = 3
    for i, l in enumerate(LAYERS):
        t = l["type"]
        if t == "conv":
            f = l["filters"] or anchors * (5 + classes)
            shapes.append((f, c, l["size"], l["size"]))
            c = f
        elif t == "route":
            c = sum(chans[j if j >= 0 else i + j] for j in l["layers"])
        chans.append(c)
    return shapes


def _act(x, kind):
    if kind == "mish":
        return x * torch.tanh(F.softplus(x))
    if kind == "leaky":
        return torch.where(x > 0, x, 0.1 * x)
    return x


@torch.no_grad()
def forward(x: torch.Tensor, weights: Sequence[Dict[str, torch.Tensor]],
            calibrate: bool = False) -> List[torch.Tensor]:
    """x NCHW fp32 (each image scaled to [0, 1]) -> the [yolo] layers'
    inputs [B, a * (5 + C), h, w], coarsest grid first.  With
    ``calibrate`` each BatchNorm normalises with its batch's mean and
    biased variance and writes them into ``weights`` as its running
    ones."""
    outs, yolo = [], []
    k = 0
    for i, l in enumerate(LAYERS):
        t = l["type"]
        if t == "conv":
            wt = weights[k]
            k += 1
            p = l["size"] // 2
            y = F.conv2d(x, wt["w"], wt.get("b"), l["stride"], p)
            if "b" not in wt:
                if calibrate:
                    wt["mean"] = y.mean(dim=(0, 2, 3))
                    wt["var"] = y.var(dim=(0, 2, 3), unbiased=False)
                c = (1, -1, 1, 1)
                y = ((y - wt["mean"].view(c))
                     / torch.sqrt(wt["var"].view(c) + BN_EPS)
                     * wt["gamma"].view(c) + wt["beta"].view(c))
            x = _act(y, l["act"])
        elif t == "route":
            x = torch.cat([outs[j if j >= 0 else i + j]
                           for j in l["layers"]], dim=1)
        elif t == "shortcut":
            x = outs[i - 1] + outs[i + l["from"]]
        elif t == "maxpool":
            s = l["size"]
            x = F.max_pool2d(F.pad(x, (s // 2,) * 4, value=float("-inf")),
                             s, 1)
        elif t == "upsample":
            x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        elif t == "yolo":
            yolo.append(x)
        outs.append(x)
    return yolo[::-1]


def scale_x_y() -> tuple:
    """The [yolo] layers' ``scale_x_y``, coarsest grid first."""
    return tuple(l["scale_x_y"] for l in LAYERS
                 if l["type"] == "yolo")[::-1]


def anchors(in_hw) -> np.ndarray:
    """[3, 3, 2] (w, h) anchors over the input size, coarsest grid first
    (each layer its [yolo] mask's)."""
    masks = [l["mask"] for l in LAYERS if l["type"] == "yolo"][::-1]
    return np.array([[(ANCHORS[m][0] / in_hw[1], ANCHORS[m][1] / in_hw[0])
                      for m in mask] for mask in masks], np.float64)


def decode(outputs: Sequence[torch.Tensor], anchors_wh: np.ndarray,
           in_hw, img_hws: torch.Tensor, classes: int):
    """Darknet's decode of the [yolo] inputs (coarsest first, [B, a *
    (5 + C), h, w]) in float64: ``x = (i + sigmoid(tx) * s - (s - 1) / 2)
    / w``, ``w = exp(tw) * anchor``, score = sigmoid(class) *
    sigmoid(objectness); then the letterbox undone
    (``correct_yolo_boxes``: the image scaled by the smaller ratio and
    rounded, centred) into (y0, x0, y1, x1) pixels of each image.
    Candidates in layer, row, column, anchor order: (boxes [B, N, 4],
    scores [B, N, C])."""
    ih, iw = float(in_hw[0]), float(in_hw[1])
    hw = img_hws.to(torch.float64)
    ratio = torch.minimum(ih / hw[:, 0], iw / hw[:, 1])
    new_h = torch.round(hw[:, 0] * ratio)
    new_w = torch.round(hw[:, 1] * ratio)
    boxes, scores = [], []
    for layer, (o, s) in enumerate(zip(outputs, scale_x_y())):
        b, _, gh, gw = o.shape
        p = o.to(torch.float64).reshape(b, 3, 5 + classes, gh, gw)
        p = p.permute(0, 3, 4, 1, 2)                     # [B, h, w, a, E]
        row = torch.arange(gh, dtype=torch.float64)[:, None, None]
        col = torch.arange(gw, dtype=torch.float64)[None, :, None]
        anc = torch.as_tensor(anchors_wh[layer], dtype=torch.float64)
        x = (col + torch.sigmoid(p[..., 0]) * s - (s - 1) / 2) / gw
        y = (row + torch.sigmoid(p[..., 1]) * s - (s - 1) / 2) / gh
        w = torch.exp(p[..., 2]) * anc[:, 0]
        h = torch.exp(p[..., 3]) * anc[:, 1]
        # correct_yolo_boxes, per image
        sx = (iw / new_w)[:, None, None, None]
        sy = (ih / new_h)[:, None, None, None]
        ox = ((iw - new_w) / 2 / iw)[:, None, None, None]
        oy = ((ih - new_h) / 2 / ih)[:, None, None, None]
        x, w = (x - ox) * sx, w * sx
        y, h = (y - oy) * sy, h * sy
        ph = hw[:, 0][:, None, None, None]
        pw = hw[:, 1][:, None, None, None]
        box = torch.stack([(y - h / 2) * ph, (x - w / 2) * pw,
                           (y + h / 2) * ph, (x + w / 2) * pw], -1)
        boxes.append(box.reshape(b, -1, 4))
        scores.append((torch.sigmoid(p[..., 5:])
                       * torch.sigmoid(p[..., 4:5])).reshape(b, -1, classes))
    return torch.cat(boxes, 1), torch.cat(scores, 1)


def nms(boxes: torch.Tensor, scores: torch.Tensor, thresh: float,
        iou_thresh: float, max_out: int):
    """Per image and class, greedily: take the best candidate at or above
    ``thresh`` (the first on a tie), drop every candidate whose IoU with
    it exceeds ``iou_thresh``, at most ``max_out`` a class.  -> per image
    a list of (class, score, box)."""
    out = []
    for i in range(boxes.shape[0]):
        found = []
        bx = boxes[i]
        area = (bx[:, 2] - bx[:, 0]).clamp_min(0) * (
            bx[:, 3] - bx[:, 1]).clamp_min(0)
        for c in range(scores.shape[2]):
            s = scores[i, :, c].clone()
            s[s < thresh] = -1.0
            for _ in range(max_out):
                j = int(torch.argmax(s))
                if s[j] < thresh:
                    break
                found.append((c, float(s[j]), bx[j].tolist()))
                y0 = torch.maximum(bx[:, 0], bx[j, 0])
                x0 = torch.maximum(bx[:, 1], bx[j, 1])
                y1 = torch.minimum(bx[:, 2], bx[j, 2])
                x1 = torch.minimum(bx[:, 3], bx[j, 3])
                inter = (y1 - y0).clamp_min(0) * (x1 - x0).clamp_min(0)
                union = area + area[j] - inter
                iou = torch.where(union > 0, inter / union,
                                  torch.zeros_like(inter))
                s[iou > iou_thresh] = -1.0
                s[j] = -1.0
        out.append(found)
    return out

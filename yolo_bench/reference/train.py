"""A training step in plain fp32 PyTorch, written from the K210 framework's
description (``utils.py``: ``letterbox_image``, the imgaug pipeline, the
label encoding of ``Helper.box_to_label``; ``yolo_loss``; Keras Adam), not
from the program.

* Preprocess: the letterbox of :mod:`serve` (products in the stated
  precision), the boxes moved by the same scale and pad; then each image's
  augment from the draws the benchmark made: the batch in the draws'
  permutation, then per slot a horizontal flip, a rotation about the image
  centre or a translation (bilinear, zeros outside), the boxes' corners
  moved by the same affine, re-boxed, clipped to the image and dropped
  when outside or empty; each image divided by its max.
* Labels: each box takes the (layer, anchor) of the best centre-aligned
  IoU (the first on a tie) and the cell floor(xy * grid); a later box
  overwrites a slot's x, y, w, h (clipped to [1e-8, 1]) and objectness 1,
  class bits accumulate.
* Loss, per layer, summed: BCE-with-logits on xy against the cell-relative
  truth, squared error on wh in log space (both times objectness and
  2 - w * h, wh also times 0.5), objectness BCE times 5, no-object BCE
  times 0.5 where no ground truth box of the image (the 64 of highest
  objectness) overlaps the prediction by the IoU limit, class BCE, each
  over the batch size; plus 5e-4 times the squared kernels of the head's
  darknet convs.
* Adam (0.9, 0.999, 1e-8) at the configured learning rate, BatchNorm on
  the batch's statistics.

The rotation is the composition of three shears Sx(a) Sy(b) Sx(a), a =
-tan(theta / 2), b = sin(theta), about the image centre, each a per-line
two-tap linear shift (the rotation the augment states), computed in a
frame padded wide enough that nothing leaves it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from yolo_bench.reference import nets as RN
from yolo_bench.reference import serve as RS

FLIP, ROTATE, TRANSLATE = 0, 1, 2
L2 = 5e-4


def _shift_lines(src: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """out[n, r, x] = src[n, r] sampled at x - offs[n, r] (linear, zeros
    outside); src [N, R, X, C]."""
    n, r, x, c = src.shape
    k = torch.floor(offs)
    f = (offs - k)[..., None, None]
    j = torch.arange(x, device=src.device)[None, None, :] - k.long()[..., None]

    def tap(idx):
        ok = (idx >= 0) & (idx < x)
        g = torch.gather(src, 2, idx.clamp(0, x - 1)[..., None]
                         .expand(n, r, x, c))
        return g * ok[..., None]

    return (1 - f) * tap(j) + f * tap(j - 1)


def rotate(imgs: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """imgs [N, h, w, C] rotated by theta [N] radians about their centre
    (|theta| <= 10 degrees)."""
    _, h, w, _ = imgs.shape
    px, py = h // 8 + 4, w // 5 + 4
    frame = F.pad(imgs, (0, 0, px, px, py, py))
    a = -torch.tan(theta / 2)[:, None]
    b = torch.sin(theta)[:, None]
    ys = torch.arange(h + 2 * py, dtype=torch.float32,
                      device=imgs.device) + 0.5 - (py + h / 2)
    xs = torch.arange(w + 2 * px, dtype=torch.float32,
                      device=imgs.device) + 0.5 - (px + w / 2)
    out = _shift_lines(frame, a * ys)
    out = _shift_lines(out.transpose(1, 2), b * xs).transpose(1, 2)
    out = _shift_lines(out, a * ys)
    return out[:, py:py + h, px:px + w]


def translate(imgs: torch.Tensor, tx: torch.Tensor,
              ty: torch.Tensor) -> torch.Tensor:
    """out[n, y, x] = imgs[n] sampled at (y - ty, x - tx), bilinear, zeros
    outside."""
    rows = _shift_lines(imgs, tx[:, None].expand(-1, imgs.shape[1]))
    return _shift_lines(rows.transpose(1, 2), ty[:, None].expand(
        -1, imgs.shape[2])).transpose(1, 2)


def _affine(p, h: int, w: int) -> torch.Tensor:
    """[B, 3, 3] forward map of each slot's branch in continuous pixel
    coordinates (pixel i spans [i, i + 1))."""
    b = p.branch.shape[0]
    m = torch.eye(3).repeat(b, 1, 1)
    for i in range(b):
        br = int(p.branch[i])
        if br == FLIP and bool(p.do_flip[i]):
            m[i, 0, 0], m[i, 0, 2] = -1.0, float(w)
        elif br == ROTATE:
            c, s = math.cos(float(p.theta[i])), math.sin(float(p.theta[i]))
            cx, cy = w / 2.0, h / 2.0
            m[i, :2] = torch.tensor([[c, -s, cx - c * cx + s * cy],
                                     [s, c, cy - s * cx - c * cy]])
        elif br == TRANSLATE:
            m[i, 0, 2], m[i, 1, 2] = float(p.tx[i]), float(p.ty[i])
    return m


def _move_boxes(boxes, valid, m, h: int, w: int):
    """boxes [B, M, 5] (class, x, y, w, h normalised) through m [B, 3, 3]."""
    size = torch.tensor([float(w), float(h)], device=boxes.device)
    xy, half = boxes[..., 1:3] * size, boxes[..., 3:5] * size / 2
    signs = torch.tensor([[-1., -1.], [1., -1.], [-1., 1.], [1., 1.]],
                         device=boxes.device)
    corners = xy[..., None, :] + signs * half[..., None, :]     # [B, M, 4, 2]
    m = m.to(boxes.device)[:, None, None]
    moved = torch.stack([
        m[..., 0, 0] * corners[..., 0] + m[..., 0, 1] * corners[..., 1]
        + m[..., 0, 2],
        m[..., 1, 0] * corners[..., 0] + m[..., 1, 1] * corners[..., 1]
        + m[..., 1, 2]], -1)
    lo, hi = moved.amin(-2), moved.amax(-2)
    inside = (hi > 0).all(-1) & (lo[..., 0] < w) & (lo[..., 1] < h)
    lo = torch.minimum(lo.clamp_min(0), size)
    hi = torch.minimum(hi.clamp_min(0), size)
    wh = (hi - lo) / size
    out = torch.cat([boxes[..., :1], (lo + hi) / 2 / size, wh], -1)
    return out, valid & inside & (wh > 0).all(-1)


def preprocess(canvases, img_hws, boxes, valid, params, in_hw,
               dtype: torch.dtype, rounding=None):
    """The batch's network input [B, h, w, 3] in [0, 1] and its boxes and
    valid mask after the augment, from the draws ``params`` (``perm``,
    ``branch``, ``do_flip``, ``theta``, ``tx``, ``ty``).  ``rounding``
    (none by default) is applied to the images after each stage: the
    letterbox, the augment and the division by the max."""
    rounding = rounding or RN.Rounding()
    h, w = in_hw
    imgs = rounding(RS.letterbox(canvases, img_hws, in_hw, dtype))
    scale, pad = RS.letterbox_params(img_hws, in_hw)
    size = img_hws.flip(-1).to(torch.float32)[:, None, :]       # (w, h)
    tgt = torch.tensor([float(w), float(h)], device=boxes.device)
    b = boxes.to(torch.float32)
    xy = (b[..., 1:3] * size * scale[:, None, None] + pad.flip(-1)[:, None])
    b = torch.cat([b[..., :1], xy / tgt,
                   b[..., 3:5] * size * scale[:, None, None] / tgt], -1)
    perm = params.perm.to(imgs.device)
    imgs, b, valid = imgs[perm], b[perm], valid[perm]
    out = imgs.clone()
    dev = imgs.device
    branch = params.branch.to(dev)
    flip = (branch == FLIP) & params.do_flip.to(dev)
    out[flip] = imgs[flip].flip(2)
    rot = branch == ROTATE
    out[rot] = rotate(imgs[rot], params.theta.to(dev)[rot])
    tr = branch == TRANSLATE
    out[tr] = translate(imgs[tr], params.tx.to(dev)[tr],
                        params.ty.to(dev)[tr])
    b, valid = _move_boxes(b, valid, _affine(params, h, w), h, w)
    return rounding(RS.unit_scale(rounding(out))), b, valid


def _centred_iou(wh_a, wh_b):
    inter = torch.minimum(wh_a, wh_b).clamp_min(0).prod(-1)
    return inter / (wh_a.prod(-1) + wh_b.prod(-1) - inter)


def encode(boxes, valid, out_hws, anchors: np.ndarray, classes: int):
    """Per layer [B, h, w, A, 5 + C] labels, on the boxes' device (built on
    the host: a slot at a time, in box order)."""
    dev = boxes.device
    bx = boxes.detach().cpu().to(torch.float32)
    ok = valid.detach().cpu()
    bsz, m = bx.shape[:2]
    anc = torch.as_tensor(anchors, dtype=torch.float32)
    nl, na = anc.shape[:2]
    iou = _centred_iou(bx[..., None, None, 3:5], anc)           # [B, M, L, A]
    best = iou.reshape(bsz, m, nl * na).argmax(-1)
    layer, anchor = (best // na).numpy(), (best % na).numpy()
    cls = bx[..., 0].long()
    cls = torch.where(cls < 0, cls + classes, cls).numpy()
    payload = bx[..., 1:5].clamp(1e-8, 1.0).numpy()
    labels = []
    for l, (gh, gw) in enumerate(out_hws):
        lab = np.zeros((bsz, gh, gw, na, 5 + classes), np.float32)
        gx = torch.floor(bx[..., 1] * gw).long().numpy()
        gy = torch.floor(bx[..., 2] * gh).long().numpy()
        for bi, j in zip(*np.nonzero(ok.numpy() & (layer == l))):
            x, y, a = gx[bi, j], gy[bi, j], anchor[bi, j]
            if not (0 <= x < gw and 0 <= y < gh):
                continue
            lab[bi, y, x, a, :4] = payload[bi, j]
            lab[bi, y, x, a, 4] = 1.0
            if 0 <= cls[bi, j] < classes:
                lab[bi, y, x, a, 5 + cls[bi, j]] = 1.0
        labels.append(torch.from_numpy(lab).to(dev))
    return labels


def _bce(z, x):
    return x.clamp_min(0) - x * z + torch.log1p(torch.exp(-x.abs()))


def _xywh_iou(pxy, pwh, gxy, gwh):
    """[..., n] IoU of each prediction [..., 2] with each truth [n, 2]."""
    p_lo, p_hi = pxy[..., None, :] - pwh[..., None, :] / 2, \
        pxy[..., None, :] + pwh[..., None, :] / 2
    g_lo, g_hi = gxy - gwh / 2, gxy + gwh / 2
    inter = (torch.minimum(p_hi, g_hi) - torch.maximum(p_lo, g_lo)
             ).clamp_min(0).prod(-1)
    return inter / (pwh.prod(-1)[..., None] + gwh.prod(-1) - inter)


def layer_loss(y_true, y_pred, layer: int, out_hws, anchors, batch: int,
               hp: dict) -> torch.Tensor:
    gh, gw = out_hws[layer]
    dev = y_pred.device
    anc = torch.as_tensor(anchors[layer], dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(torch.arange(gh, device=dev),
                            torch.arange(gw, device=dev), indexing="ij")
    offset = torch.stack([gx, gy], -1)[:, :, None, :].float()
    grid = torch.tensor([float(gw), float(gh)], device=dev)
    p = y_pred.float()
    obj = y_true[..., 4:5]
    has = y_true[..., 4] > hp["obj_thresh"]
    pred_xy = (torch.sigmoid(p[..., :2]) + offset) / grid
    pred_wh = torch.exp(p[..., 2:4]) * anc
    with torch.no_grad():
        conf = y_true[..., 4].reshape(batch, -1)
        top, idx = torch.sort(conf, dim=1, descending=True, stable=True)
        top, idx = top[:, :64], idx[:, :64]
        gt = torch.gather(y_true[..., :4].reshape(batch, -1, 4), 1,
                          idx[..., None].expand(-1, -1, 4))
        ious = torch.stack([_xywh_iou(pred_xy[i], pred_wh[i], gt[i, :, :2],
                                      gt[i, :, 2:])
                            * (top[i] > hp["obj_thresh"])
                            for i in range(batch)])
        ignore = (ious.amax(-1, keepdim=True) < hp["iou_thresh"]).float()
    true_xy = y_true[..., :2] * grid - offset
    true_wh = torch.where(has[..., None],
                          torch.log(y_true[..., 2:4].clamp_min(1e-30) / anc),
                          torch.zeros_like(y_true[..., 2:4]))
    cw = 2.0 - y_true[..., 2:3] * y_true[..., 3:4]
    xy = (obj * cw * _bce(true_xy, p[..., :2])).sum() / batch
    wh = (obj * cw * hp["wh_weight"] * (true_wh - p[..., 2:4]) ** 2).sum() \
        / batch
    conf_bce = _bce(obj, p[..., 4:5])
    o = hp["obj_weight"] * (obj * conf_bce).sum() / batch
    no = hp["noobj_weight"] * ((1 - obj) * ignore * conf_bce).sum() / batch
    c = (obj * _bce(y_true[..., 5:], p[..., 5:])).sum() / batch
    return o + no + c + xy + wh


def l2_kernels(net) -> List[torch.Tensor]:
    """The head's darknet conv kernels (scopes ``dark_conv_*``)."""
    return [m.weight for n, m in RN.conv_layers(net)
            if any(part.startswith("dark_conv") for part in n.split("."))]


class Adam:
    """Adam as Keras and optax state it: m, v, and the bias-corrected step
    lr * m_hat / (sqrt(v_hat) + eps)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 b1=0.9, b2=0.999, eps=1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, b1, \
            b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_((1 - self.b1) * g)
            self.v[k].mul_(self.b2).add_((1 - self.b2) * g * g)
            mh = self.m[k] / (1 - self.b1 ** self.t)
            vh = self.v[k] / (1 - self.b2 ** self.t)
            p.sub_(self.lr * mh / (vh.sqrt() + self.eps))


def train_steps(net, batches: Sequence[tuple], cfg: dict, hp: dict,
                rounding=None) -> dict:
    """Run the steps of ``batches`` (each (canvases, img_hws, boxes, valid,
    draws)) from ``net``'s tensors; returns each step's loss (without the
    l2 term), the first step's gradients and the parameters after the last,
    by name.  ``rounding`` (the control's) goes under every conv and onto
    the images after each preprocess stage."""
    RN.ensure_fp32()
    params = {k: v for k, v in net.named_parameters()}
    opt = Adam(params, hp["lr"])
    dtype = getattr(torch, cfg["precision"])
    anchors = np.asarray(cfg["anchors"], np.float32)
    na = cfg["anchors_per_layer"]
    losses, first = [], None
    ctx = RN.Ctx("train", rounding)
    for canv, hws, boxes, valid, draws in batches:
        with torch.no_grad():
            imgs, b, v = preprocess(canv, hws, boxes, valid, draws,
                                    cfg["in_hw"], dtype, rounding)
            labels = encode(b, v, cfg["out_hws"], anchors, cfg["classes"])
        outs = RN.forward(net, imgs, na, ctx)
        main = sum(layer_loss(t, o, l, cfg["out_hws"], anchors,
                              imgs.shape[0], hp)
                   for l, (t, o) in enumerate(zip(labels, outs)))
        total = main + L2 * sum((k * k).sum() for k in l2_kernels(net))
        grads = torch.autograd.grad(total, list(params.values()))
        g = dict(zip(params, grads))
        if first is None:
            first = {k: t.detach().clone() for k, t in g.items()}
        opt.step(g)
        losses.append(float(main.detach()))
    return {"losses": losses, "grads": first,
            "params": {k: v.detach().clone() for k, v in params.items()}}

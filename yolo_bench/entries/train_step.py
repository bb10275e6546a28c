"""Entry ``train_step``: the port's fused train step
(``make_fused_train_step`` with ``make_preprocess_fn(is_training=True)``)
in the configuration's dtype, chained through its state, on pool batches
of staging canvases held on the card.  The augment's draws are the
benchmark's own, made from the seed and handed in as ``params``.

Set-up builds the one train state from the made weights and drives it
through the first three steps, on three distinct pool batches, through
the same call the window makes; their losses, the Adam state after the
first and the parameters after the third are kept, and the same state
goes on into the window.  The check runs the reference over those three
steps from the same weights, inputs and draws and compares each step's
loss, the first gradient as Adam got it (its first moment over 1 - b1),
by the median leaf, and the parameters' change over the three, by the
worst leaf (``compare.py``)."""

from __future__ import annotations

import math

import numpy as np
import torch

from yolo_bench import compare, counts, traffic, weights
from yolo_bench import trace as TR
from yolo_bench.reference import nets as RN
from yolo_bench.reference import train as RT

CHECKED_STEPS = 3
B1 = 0.9
# leaves whose reference gradient is below this share of the median
# leaf's are left out of the gradient and change comparisons: they move
# under Adam by round-off alone
GRAD_FLOOR = 1e-3
# what a builder file may define that ``reference/train.py`` (YOLOv3's loss
# and its decode, ``sigmoid(t) + offset``) does not honour
NOT_TRAINED_BY_THE_REFERENCE = ("decode", "scale_x_y")


def _draws(batch: int, in_hw, gen: torch.Generator):
    """One batch's stratified augment: ceil(B/3) flip slots, floor(B/3)
    rotation slots, the rest translation slots, over a random permutation;
    a flip bit, a rotation U(-10, 10) degrees and a translation U(-0.1,
    0.1) of each side per slot (the branch picks which applies)."""
    from k210_yolo_framework_tpu_torch.ops.augment import AugmentParams

    h, w = in_hw
    perm = torch.randperm(batch, generator=gen)
    n_flip = batch - 2 * (batch // 3)
    branch = torch.full((batch,), RT.TRANSLATE, dtype=torch.int64)
    branch[:n_flip] = RT.FLIP
    branch[n_flip:n_flip + batch // 3] = RT.ROTATE
    u = torch.rand(4, batch, generator=gen)
    return AugmentParams(perm, branch, u[0] < 0.5,
                         torch.deg2rad(u[1] * 20.0 - 10.0),
                         (u[2] * 0.2 - 0.1) * w, (u[3] * 0.2 - 0.1) * h)


def _refuse_own_decode(model_def: str) -> None:
    """A net whose builder file brings its own decode or decode constants
    would be trained against YOLOv3's loss, which reads neither: refuse it
    until the reference has its loss."""
    own = [k for k in NOT_TRAINED_BY_THE_REFERENCE
           if hasattr(RN.builder_file(model_def), k)]
    if own:
        raise ValueError(
            f"{model_def}: its builder file defines {own}, which "
            f"reference/train.py (YOLOv3's loss and decode) does not "
            f"honour; a train cell of this net needs a reference loss of "
            f"its own")


def hyper() -> dict:
    from k210_yolo_framework_tpu_torch.config import TrainConfig
    c = TrainConfig()
    return {"lr": c.init_learning_rate, "obj_thresh": c.obj_thresh,
            "iou_thresh": c.iou_thresh, "obj_weight": c.obj_weight,
            "noobj_weight": c.noobj_weight, "wh_weight": c.wh_weight}


class Entry:
    def __init__(self, cell, seed: int, device: torch.device, trace: bool):
        self.cell, self.seed, self.device = cell, seed, device
        cfg, tr = cell.config, cell.traffic
        _refuse_own_decode(cfg["model_def"])
        self.images_per_call = int(tr["batch"])
        self.inputs = traffic.make(tr, seed, device)
        gen = torch.Generator().manual_seed(seed * 8 + 2)
        self.draws = [_draws(self.images_per_call, cfg["in_hw"], gen)
                      for _ in range(int(tr["pool"]))]
        net = RN.build(cfg["model_def"], cfg["anchors_per_layer"],
                       cfg["classes"], cfg.get("alpha", 1.0)).to(device)
        weights.make_state(net, cfg, seed * 8, device)
        self.p0 = weights.state_of(net)
        self.hp = hyper()
        if cfg.get("train_as") == "reference_fp8":
            self._control()
            return
        self._program(trace)

    def _batch(self, p: int):
        x = self.inputs
        return (x["canvases"][p], x["img_hws"][p], x["boxes"][p],
                x["valid"][p])

    def _program(self, trace: bool) -> None:
        from k210_yolo_framework_tpu_torch.config import TrainConfig, YoloSpec
        from k210_yolo_framework_tpu_torch.data.pipeline import (
            make_preprocess_fn,
        )
        from k210_yolo_framework_tpu_torch.models import build_network
        from k210_yolo_framework_tpu_torch.training import train as TT

        cfg = self.cell.config
        spec = YoloSpec.create(cfg["in_hw"], cfg["out_hws"], cfg["classes"],
                               np.asarray(cfg["anchors"], np.float32))
        net = build_network(cfg["model_def"], spec.in_hw, spec.nanchors,
                            spec.class_num, alpha=cfg.get("alpha", 1.0),
                            generator=torch.Generator().manual_seed(0))
        net.load_state_dict(self.p0)
        tcfg = TrainConfig(batch_size=self.images_per_call)
        self.state = TT.create_train_state(net, tcfg, self.device)
        dtype = getattr(torch, cfg["precision"])
        pp = make_preprocess_fn(spec, is_training=True, dtype=dtype)

        def preprocess(*args, **kwargs):
            with TR.span("preprocess", trace):
                return pp(*args, **kwargs)

        self.step = TT.make_fused_train_step(spec, tcfg, preprocess, dtype)
        params = dict(self.state.net.named_parameters())
        losses = []
        for i in range(CHECKED_STEPS):
            self.call(i - CHECKED_STEPS)
            losses.append(self.logs["loss"].detach().clone())
            if i == 0:
                opt = self.state.optimizer.state
                self.got_grads = {k: (opt[v]["exp_avg"] / (1 - B1)).clone()
                                  if v in opt else torch.zeros_like(v)
                                  for k, v in params.items()}
        self.got_losses = [float(x) for x in losses]
        self.got_params = {k: v.detach().clone() for k, v in params.items()}

    def _control(self) -> None:
        """The reference in fp8 in the program's place."""
        got = self._reference(RN.FP8Rounding())
        self.got_losses = got["losses"]
        self.got_grads = got["grads"]
        self.got_params = got["params"]
        self.step = None

    def call(self, i: int) -> None:
        if self.step is None:
            return
        p = (i + CHECKED_STEPS) % len(self.draws)
        self.state, self.logs = self.step(self.state, *self._batch(p),
                                          params=self.draws[p])

    def drain(self) -> None:
        if self.step is not None:
            float(self.logs["loss"])

    def free(self) -> None:
        self.state = self.step = self.logs = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, rounding=None) -> dict:
        net = RN.build(self.cell.config["model_def"],
                       self.cell.config["anchors_per_layer"],
                       self.cell.config["classes"],
                       self.cell.config.get("alpha", 1.0)).to(self.device)
        net.load_state_dict(self.p0)
        batches = [self._batch(p) + (self.draws[p],)
                   for p in range(CHECKED_STEPS)]
        return RT.train_steps(net, batches, self.cell.config, self.hp,
                              rounding)

    def check(self) -> dict:
        want = self._reference()
        g_want = {k: float(v.norm()) for k, v in want["grads"].items()}
        med = float(np.median(list(g_want.values())))
        keep = [k for k, v in g_want.items() if v >= GRAD_FLOOR * med]
        g_got = {k: float(self.got_grads[k].norm()) for k in keep}
        d_want = {k: float((want["params"][k] - self.p0[k]).norm())
                  for k in keep}
        d_got = {k: float((self.got_params[k] - self.p0[k]).norm())
                 for k in keep}
        loss_gap = max(abs(a - b) / abs(b) for a, b in
                       zip(self.got_losses, want["losses"]))
        if not all(math.isfinite(x) for x in self.got_losses):
            loss_gap = float("inf")
        grad = compare.leaf_gaps(g_got, g_want, keep)
        change = compare.leaf_gaps(d_got, d_want, keep)
        worst_grad = max(grad, key=grad.get)
        worst_change = max(change, key=change.get)
        self.detail = {"losses": self.got_losses,
                       "ref_losses": want["losses"],
                       "grad_worst": [worst_grad, grad[worst_grad]],
                       "change_worst": [worst_change, change[worst_change]],
                       "left_out": sorted(set(g_want) - set(keep))}
        got = {"loss_gap": loss_gap,
               "grad_median_gap": float(np.median(list(grad.values()))),
               "change_gap": change[worst_change]}
        limits = self.cell.check["limits"]
        return {k: (got[k], float(limits[k])) for k in limits}

    def counts(self) -> dict:
        cfg, tr = self.cell.config, self.cell.traffic
        rotated = self.images_per_call // 3
        return {"train_flops_per_image": counts.train_flops(cfg),
                "rotate": counts.rotate_work(
                    rotated, *cfg["in_hw"],
                    torch.tensor([], dtype=getattr(torch, cfg["precision"]))
                    .element_size())}

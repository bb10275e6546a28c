"""The plain reference agrees with the port at tiny sizes on the CPU, in
fp32: the builders' forward (tiny_yolo's from its builder file), the
decode and NMS, one train step."""

import numpy as np
import pytest
import torch

from yolo_bench import traffic, weights
from yolo_bench.entries import train_step as TS
from yolo_bench.reference import nets as RN
from yolo_bench.reference import serve as RS
from yolo_bench.reference import train as RT

V1 = {"model_def": "yolo_mobilev1", "alpha": 0.75, "in_hw": [64, 96],
      "out_hws": [[2, 3], [4, 6]], "classes": 20, "anchors_per_layer": 3,
      "anchors": [[[0.76, 0.57], [0.69, 0.88], [0.47, 0.34]],
                  [[0.33, 0.70], [0.18, 0.39], [0.08, 0.15]]],
      "precision": "float32",
      "weights": {"box_logit_std": 0.5, "score_logit_std": 1.8,
                  "conf_bias": -1.0}}
YOLO = dict(V1, model_def="yolo", in_hw=[64, 64],
            out_hws=[[2, 2], [4, 4], [8, 8]],
            anchors=[[[0.6, 0.5], [0.3, 0.3], [0.2, 0.2]],
                     [[0.1, 0.2], [0.1, 0.1], [0.1, 0.2]],
                     [[0.02, 0.02], [0.03, 0.05], [0.05, 0.04]]])
# tiny_yolo's reference is a builder file (``reference/builders``)
TINY = dict(V1, model_def="tiny_yolo")
CPU = torch.device("cpu")


def _made(cfg, seed=3):
    ref = RN.build(cfg["model_def"], 3, cfg["classes"], cfg.get("alpha", 1))
    weights.make_state(ref, cfg, seed, CPU)
    inp = traffic.make({"pool": 1, "batch": 3, "canvas_hw": [80, 120],
                        "image_hws": [[80, 120], [70, 100], [60, 120]]},
                       seed, CPU)
    weights.calibrate(ref, cfg, inp["canvases"][0], inp["img_hws"][0])
    return ref, weights.state_of(ref), inp


def _program_net(cfg, state):
    from k210_yolo_framework_tpu_torch.models import build_network
    net = build_network(cfg["model_def"], cfg["in_hw"], 3, cfg["classes"],
                        alpha=cfg.get("alpha", 1.0))
    net.load_state_dict(state)
    return net.eval()


@pytest.mark.parametrize("cfg", [V1, YOLO, TINY],
                         ids=["yolo_mobilev1", "yolo", "tiny_yolo"])
@torch.no_grad()
def test_forward_and_letterbox_match_the_port(cfg):
    from k210_yolo_framework_tpu_torch.ops import letterbox as LB
    ref, state, inp = _made(cfg)
    c, h = inp["canvases"][0], inp["img_hws"][0]
    mine = RS.letterbox(c, h, cfg["in_hw"])
    theirs = LB.letterbox_image(c, h, cfg["in_hw"])
    # one grey level where a sample lands on a pixel to rounding
    assert (mine - theirs).abs().max() <= 1
    assert (mine != theirs).float().mean() < 0.02
    net = _program_net(cfg, state)
    got = net(theirs.to(torch.uint8), input_scale=1.0 / theirs.flatten(1)
              .amax(1))
    want = RN.forward(ref, RS.unit_scale(theirs), 3)
    for g, w in zip(got, want):
        # fp32 sums in another order over up to 75 layers
        torch.testing.assert_close(g, w, rtol=1e-4, atol=5e-4)


@torch.no_grad()
def test_decode_and_nms_match_the_port():
    from k210_yolo_framework_tpu_torch.config import YoloSpec
    from k210_yolo_framework_tpu_torch.ops.yolo_head_pallas import (
        fused_decode_nms_reference,
    )
    spec = YoloSpec.create(V1["in_hw"], V1["out_hws"], 20,
                           np.asarray(V1["anchors"], np.float32))
    gen = torch.Generator().manual_seed(0)
    logits = [torch.randn(4, h, w, 3, 25, generator=gen) * 2
              for h, w in V1["out_hws"]]
    hws = torch.tensor([[64, 96], [50, 96], [64, 70], [30, 40]],
                       dtype=torch.int32)
    for thresh, iou, max_out in ((0.7, 0.3, 30), (0.05, 0.45, 5)):
        res = fused_decode_nms_reference(logits, spec, hws, thresh, iou,
                                         max_out)
        boxes, scores = RS.decode(logits, np.asarray(V1["anchors"]),
                                  V1["in_hw"], hws)
        kept, _ = RS.nms(boxes, scores, thresh, iou, max_out)
        dets = RS.detections(boxes, scores, kept)
        for b in range(4):
            v = res.valid[b]
            got = sorted(zip(res.classes[b][v].tolist(),
                             res.scores[b][v].tolist()))
            want = sorted(zip(dets[b][2].tolist(), dets[b][1].tolist()))
            assert [c for c, _ in got] == [c for c, _ in want]
            np.testing.assert_allclose([s for _, s in got],
                                       [s for _, s in want], rtol=1e-5)
            np.testing.assert_allclose(
                np.sort(res.boxes[b][v].numpy(), 0),
                np.sort(dets[b][0], 0), rtol=1e-4, atol=1e-3)


def test_one_train_step_matches_the_port():
    from k210_yolo_framework_tpu_torch.config import TrainConfig, YoloSpec
    from k210_yolo_framework_tpu_torch.data.pipeline import (
        make_preprocess_fn,
    )
    from k210_yolo_framework_tpu_torch.training import train as TT
    cfg = dict(V1)
    ref = RN.build("yolo_mobilev1", 3, 20, 0.75)
    weights.make_state(ref, cfg, 5, CPU)
    state = weights.state_of(ref)
    inp = traffic.make({"pool": 1, "batch": 6, "canvas_hw": [80, 120],
                        "image_hws": [[72, 96]], "boxes_per_image": 3,
                        "box_slots": 8, "classes": 20, "box_xy": [0.2, 0.8],
                        "box_wh": [0.1, 0.4]}, 5, CPU)
    draws = TS._draws(6, cfg["in_hw"], torch.Generator().manual_seed(1))
    batch = tuple(inp[k][0] for k in ("canvases", "img_hws", "boxes",
                                      "valid"))
    want = RT.train_steps(ref, [batch + (draws,)], cfg, TS.hyper())

    spec = YoloSpec.create(cfg["in_hw"], cfg["out_hws"], 20,
                           np.asarray(cfg["anchors"], np.float32))
    net = _program_net(cfg, state)
    tcfg = TrainConfig(batch_size=6)
    st = TT.create_train_state(net, tcfg, CPU)
    step = TT.make_fused_train_step(
        spec, tcfg, make_preprocess_fn(spec, True, torch.float32))
    st, logs = step(st, *batch, params=draws)
    assert abs(float(logs["loss"]) - want["losses"][0]) \
        <= 1e-4 * want["losses"][0]
    opt = st.optimizer.state
    for name, p in st.net.named_parameters():
        # by norm: a unit at a kink or a box at the ignore mask's IoU limit
        # sends one element's gradient another way to rounding
        g = (opt[p]["exp_avg"] / 0.1).norm()
        torch.testing.assert_close(g, want["grads"][name].norm(), rtol=2e-3,
                                   atol=0.0)
        # Adam's first step moves each element by the learning rate in its
        # gradient's sign (less where it is near eps), which rounding
        # flips or shrinks where the gradient is ~0:
        # the change's norm, not its elements
        moved = (p.detach() - state[name]).norm()
        torch.testing.assert_close(moved, (want["params"][name]
                                           - state[name]).norm(), rtol=1e-2,
                                   atol=0.0)

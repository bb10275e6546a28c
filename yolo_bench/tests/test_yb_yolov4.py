"""YOLOv4 (``configs/yolov4-cspdarknet53-voc-608.json``, cell
``yolov4-608-eval-b32``): the harness's reference (the builder file
``reference/builders/yolov4.py``) agrees with the port on the CPU; its
small cut comes out correct; a copy of the builder file without
``scale_x_y`` is caught; the counts the readers divide by."""

import json

import numpy as np
import pytest
import torch

from yolo_bench import counts, traffic, weights
from yolo_bench import run as R
from yolo_bench.metrics._epilogue_bytes import epilogue_bytes
from yolo_bench.reference import nets as RN
from yolo_bench.tests import _small

CELL = "yolov4-608-eval-b32"
CFG = R.load_json(R.HERE / "configs" / "yolov4-cspdarknet53-voc-608.json")
CPU = torch.device("cpu")


@torch.no_grad()
def test_the_builder_file_matches_the_port():
    """The same made state in the reference and the port's ``yolov4`` at
    128x128, fp32: logits within fp32 summation order over 110 layers;
    the reference's decode against the port's head decode with the net's
    ``scale_x_y``."""
    from k210_yolo_framework_tpu_torch.config import YoloSpec
    from k210_yolo_framework_tpu_torch.models import yolonet as TY
    from k210_yolo_framework_tpu_torch.ops import yolo_head_pallas as TH

    cfg = dict(CFG, in_hw=[128, 128], out_hws=[[4, 4], [8, 8], [16, 16]],
               precision="float32")
    ref = RN.build("yolov4", 3, 20)
    weights.make_state(ref, cfg, 3, CPU)
    inp = traffic.make({"pool": 1, "batch": 3, "canvas_hw": [160, 160],
                        "image_hws": [[150, 100], [90, 160], [160, 160]]},
                       3, CPU)
    imgs = inp["canvases"][0].to(torch.float32)
    imgs = imgs[:, :128, :128] / 255.0
    weights.calibrate(ref, cfg, inp["canvases"][0], inp["img_hws"][0])
    net = TY.YoloV4(3, 20, cfg["in_hw"])
    net.load_state_dict(weights.state_of(ref))
    got = net.eval()(imgs)
    want = RN.forward(ref, imgs, 3)
    for g, w in zip(got, want):
        assert float((g - w).norm() / w.norm()) < 1e-4
    hws = inp["img_hws"][0]
    boxes, scores = RN.builder_file("yolov4").decode(
        want, np.asarray(cfg["anchors"], np.float32), cfg["in_hw"], hws)
    spec = YoloSpec.create(cfg["in_hw"], cfg["out_hws"], 20,
                           np.asarray(cfg["anchors"], np.float32),
                           net.scale_x_y)
    p = TH._flatten_preds(want, 20)
    lbox = TH.letterbox_inverse_params(hws, spec.in_hw)
    y0, x0, y1, x1, sc = TH._decode(p, TH._geometry_on(spec, CPU), lbox,
                                    classes=20, class_softmax=False)
    mine = torch.cat([y0, x0, y1, x1], 1).transpose(1, 2)
    torch.testing.assert_close(mine, boxes, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(sc.transpose(1, 2), scores, rtol=1e-6,
                               atol=1e-7)


def test_the_small_cell_is_correct():
    line = _small.run(CELL, seed=7)
    assert line["correct"] is True, line["check"]
    assert line["detail"]["served"] > 0


# The program in fp32 and a tolerance of 0.0015: a missing scale_x_y
# moves box centres by (s - 1) * |sigmoid(t) - 0.5| of a cell, about 1e-3
# of the image here, which the cell's own bf16 tolerance (0.04) does not
# see.  At 0.0015 the fp32 program reads 0.027-0.044 (its letterbox a grey
# level off the reference's on some pixels), the copy without the scale
# 0.30-0.32 (seeds 8 and 11), against the cell's limit of 0.18.
FINE = {"config": {"precision": "float32"}, "check": {"match_tau": 0.0015}}


def test_a_builder_file_without_scale_x_y_is_not_correct(tmp_path,
                                                         monkeypatch):
    """The builder file as it is passes at ``FINE``; a copy whose
    ``SCALE_X_Y`` is all 1 (darknet's decode without the scale) fails."""
    src = (RN.BUILDER_DIR / "yolov4.py").read_text()
    assert src.count("SCALE_X_Y = (1.05, 1.1, 1.2)") == 1
    assert _small.run(CELL, seed=8, **FINE)["correct"] is True
    (tmp_path / "yolov4.py").write_text(
        src.replace("SCALE_X_Y = (1.05, 1.1, 1.2)", "SCALE_X_Y = (1, 1, 1)"))
    monkeypatch.setattr(RN, "BUILDER_DIR", tmp_path)
    line = _small.run(CELL, seed=8, **FINE)
    assert line["correct"] is False, line["check"]


def test_the_forward_flops_are_pinned():
    """127.46 GFLOP an image at 20 classes, the convs alone.  At 80
    classes the count is 128.39; darknet reports 128.46 BFLOPs for the
    cfg, which also counts its three max-pools (275 window taps on 19 x
    19 x 512: 0.051) and its 23 shortcut adds (0.018)."""
    assert counts.forward_flops(CFG) == 127457929216
    assert round(counts.forward_flops(dict(CFG, classes=80)) / 1e9, 2) \
        == 128.39


@pytest.mark.parametrize("config,images,nbytes", [
    ("yolov3-darknet53-voc-608", 32, 17164238848),
    ("yolo_mobilev1-a0.75-voc-224x320", 128, 2796093440),
    ("yolov4-cspdarknet53-voc-608", 32, 18500943872)])
def test_epilogue_bytes(config, images, nbytes):
    """The epilogue's bytes a call: YOLOv3 at B = 32 and v1 at B = 128
    equal the bounds the epilogue kernel was measured against (17.164 GB,
    2.796 GB: the conv output read in bf16, the residual in fp32, the
    store in the width the net keeps); YOLOv4's 72 Mish and 35 leaky
    ConvBNs, 28 of them stored wide (``part_b`` and the units' sums), 23
    with a residual."""
    cfg = R.load_json(R.HERE / "configs" / f"{config}.json")
    assert epilogue_bytes(cfg, images) == nbytes
    assert epilogue_bytes(json.loads(json.dumps(cfg)), 1) * images == nbytes

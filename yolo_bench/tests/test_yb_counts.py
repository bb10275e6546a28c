"""The work the readers divide by equals counts made by hand."""

import pytest
import torch

from yolo_bench import counts
from yolo_bench import run as R
from yolo_bench.reference import nets as RN

V1 = {"model_def": "yolo_mobilev1", "anchors_per_layer": 3, "classes": 20,
      "alpha": 0.75, "in_hw": [224, 320]}
YOLO = {"model_def": "yolo", "anchors_per_layer": 3, "classes": 20,
        "in_hw": [96, 96]}


def _by_hand(cfg):
    """2 * output elements * (input channels a group * k * k) per conv,
    and the stem's, from output shapes recorded on the meta device."""
    with torch.device("meta"):
        net = RN.build(cfg["model_def"], 3, cfg["classes"],
                       cfg.get("alpha", 1.0))
    sizes = {}
    for name, conv in RN.conv_layers(net):
        conv.register_forward_hook(
            lambda m, a, o, name=name: sizes.__setitem__(name, o.numel()))
    RN.forward(net, torch.zeros((1, *cfg["in_hw"], 3), device="meta"), 3)
    per = {n: 2 * sizes[n] * c.weight[0].numel()
           for n, c in RN.conv_layers(net)}
    return per, RN.conv_layers(net)[0][0]


def test_forward_and_train_flops_by_hand():
    for cfg in (V1, YOLO):
        per, stem = _by_hand(cfg)
        assert counts.forward_flops(cfg) == sum(per.values())
        # backward: an input and a weight gradient per conv, the stem's
        # input needing none
        assert counts.train_flops(cfg) == 3 * sum(per.values()) - per[stem]


def test_the_demo_nets_published_work():
    assert counts.forward_flops(V1) == 1464771840
    assert round(counts.forward_flops(dict(YOLO, in_hw=[608, 608])) / 1e9,
                 1) == 139.8


@pytest.mark.parametrize("config,forward,train", [
    ("yolo_mobilev1-a0.75-voc-224x320", 1464771840, 4371091200),
    ("yolov3-darknet53-voc-608", 139760347136, None)])
def test_the_configurations_counts_are_as_they_were(config, forward, train):
    """The counts the readers divide by, from the configuration files."""
    cfg = R.load_json(R.HERE / "configs" / f"{config}.json")
    assert counts.forward_flops(cfg) == forward
    if train is not None:
        assert counts.train_flops(cfg) == train


def test_head_and_rotation_work_by_hand():
    w = counts.head_work(batch=2, n=10, classes=3, max_out=4, live=7)
    assert w["bytes"] == 4 * (2 * 10 * 8 + 8 * 10 + 8 * 2 + 2 * 3 * 4 * 5)
    assert w["ops"] == 2 * 10 * 35 + 2 * 10 * 3 * 4 + 7 * 15
    r = counts.rotate_work(images=2, h=4, w=5, elem_bytes=2)
    assert r == {"bytes": 2 * 2 * 4 * 5 * 3 * 2, "ops": 2 * 4 * 5 * 3 * 9}
    assert counts.bound_s(3.35e12, 67e12, 67e12) == 1.0

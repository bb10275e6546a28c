"""The port's yolo_mobilev2 against the JAX package's, and BN momentum per
builder (fault p: MobileNetV2 0.999, the others 0.99).

Both nets run the same weights (``torch_parity.jax_weights``: the JAX
net's variable shapes, every leaf drawn from a numpy seed) at 64x96, 3
anchors, 3 classes: grids 2x3 and 4x6.  alpha 0.75 has the K210 expand
caps (blocks 1 and 2 at 48 and 124 channels) and head width 128; alpha
0.35 neither, and head width 192.

Tolerances:
* eval forward in fp32: rtol / atol 1e-5, ``test_forward_matches_jax_fp32``'s
  (the two sides sum the convs in other orders; measured 1.4e-6);
* eval forward in bf16 on the same 4 uint8 images, every head output
  against the port's own float64 forward (the exact function both bf16
  programs round): the port's total absolute error at most 1.3x the JAX
  program's, and port against JAX at most 1.3x it.  Measured over 4
  seeds: 1.13-1.18x and 1.16-1.22x (this seed: 1.14 / 1.21 at alpha 0.35,
  1.18 / 1.20 at 0.75).  A rounding point moved (BN started in bf16)
  gives 1.51-1.68x and 1.54-1.72x.  The absolute bounds of
  ``test_bf16_serving_matches_jax`` (60% of the logits bitwise equal, mean
  difference 2.5e-4) hold for yolo_mobilev1 at the JAX init on that test's
  scene; the same v1 with these weights gives 40-43% and 3.9-5.7e-4, and
  the 52-layer v2 20-30% and 9e-4-2.0e-3, so they measure the weights;
* train mode: ``torch_parity.assert_train_mode_close``.  Each output
  within 3e-4 of its largest JAX entry of JAX's, and each move of a
  running statistic (new less drawn: 1 - 0.999 of batch less running)
  within 5e-4 of its largest; measured at most 8.2e-5 and 1.2e-4 over
  both witnesses.  52 train-mode BatchNorms over as few as 24 values each
  amplify rounding, and a move carries the rounding of the statistic it
  is added to (an fp32 ulp of a variance near 1 is 1e-4 of a move of
  1e-3).  A BatchNorm at 0.99 moves 10x as far: the check then fails at
  20x its limit.  The port's distance from its own float64 forward is
  also at most twice JAX's (measured 1.0x at most).  The net as built is ill-conditioned at these
  weights: moving every input pixel by one fp32 ulp moves the port's own
  gradient of block 11's expand BN bias by 2.2% of its largest entry, and
  of the stem by 1.7%, through the ReLU6 kinks.  So every gradient is held
  to 1e-3 on the smooth witness (the kinks replaced by softplus on both
  sides), ReLU6 itself is held to JAX's forward and gradient in
  ``test_torch_train.py``, and the net as built to its outputs and running
  statistics.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from k210_yolo_framework_tpu.models import build_network as jax_build
from k210_yolo_framework_tpu.models import mobilenet_v2 as JV2
from k210_yolo_framework_tpu_torch.models import build_network
from k210_yolo_framework_tpu_torch.models import mobilenet_v2 as TV2
from k210_yolo_framework_tpu_torch.models.layers import BatchNorm
from k210_yolo_framework_tpu_torch.training import checkpoint as TC

from torch_parity import (
    assert_train_mode_close,
    bf16_errors,
    jax_weights,
    port_net,
    to_t,
    train_mode_vs_jax,
)

torch.set_num_threads(1)

IN_HW, NANCHORS, CLASSES = (64, 96), 3, 3


def images(seed, in_hw=IN_HW, b=2):
    """uint8 images [b, h, w, 3] and their 1 / max."""
    x = np.random.default_rng(seed).integers(0, 256, (b, *in_hw, 3))
    x = x.astype(np.uint8)
    return x, (1.0 / x.reshape(b, -1).max(1)).astype(np.float32)


@pytest.mark.parametrize("alpha", [0.35, 0.75, 1.4])
def test_widths_match_jax(alpha):
    """Every leaf's shape (the caps, the int() before make_divisible, the
    fixed stem and conv_last) against the JAX net's."""
    _, _, flat = jax_weights("yolo_mobilev2", (64, 64), 3, 20, alpha)
    sd = TC.state_dict_from_flat(flat, port_net("yolo_mobilev2", (64, 64),
                                                3, 20, alpha))
    assert len(sd) == len(flat) == 279
    caps = tuple(flat[f"params/backbone/block_{i}/expand/conv/kernel"]
                 .shape[-1] for i in (1, 2))
    uncapped = tuple(6 * TV2.make_divisible(int(f * alpha)) for f in (16, 24))
    assert caps == ((48, 124) if alpha > 0.6 else uncapped)
    assert flat["params/backbone/stem/conv/kernel"].shape[-1] == 32
    assert flat["params/backbone/conv_last/conv/kernel"].shape[-1] == (
        1280 if alpha <= 1 else TV2.make_divisible(1280 * alpha))
    for v in (3, 7.5, 12.25, 96 * 0.35, 160 * 1.4, 1280 * 1.4):
        assert TV2.make_divisible(v) == JV2.make_divisible(v)


@pytest.mark.parametrize("alpha", [0.35, 0.75])
def test_eval_forward_matches_jax_fp32(alpha):
    _, variables, flat = jax_weights("yolo_mobilev2", IN_HW, NANCHORS,
                                     CLASSES, alpha)
    jnet = jax_build("yolo_mobilev2", IN_HW, NANCHORS, CLASSES, alpha=alpha)
    x, scale = images(1)
    want = jax.jit(lambda v, a, s: jnet.apply(v, a, input_scale=s))(
        variables, jnp.asarray(x), jnp.asarray(scale))
    with torch.inference_mode():
        got = port_net("yolo_mobilev2", IN_HW, NANCHORS, CLASSES, alpha,
                       flat)(to_t(x), input_scale=to_t(scale))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want] == [
        (2, 2, 3, 3, 8), (2, 4, 6, 3, 8)]
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(w[0] - w[1]).mean() > 1e-3   # the image matters
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("alpha", [0.35, 0.75])
def test_eval_forward_matches_jax_bf16(alpha):
    port_err, jax_err, apart = bf16_errors(
        "yolo_mobilev2", IN_HW, NANCHORS, CLASSES, alpha, *images(1, b=4))
    assert port_err <= 1.3 * jax_err and apart <= 1.3 * jax_err, (
        port_err / jax_err, apart / jax_err)


def test_bn_momentum_per_builder():
    """Fault p: MobileNetV2's BatchNorms run at 0.999, every other one at
    0.99, and a train-mode forward moves each running mean by exactly
    ``m * r + (1 - m) * batch``."""
    for name, m in (("yolo_mobilev2", 0.999), ("yolo_mobilev1", 0.99),
                    ("tiny_yolo", 0.99), ("yolo", 0.99)):
        net = build_network(name, IN_HW, NANCHORS, CLASSES, alpha=0.75)
        backbone = set(net.backbone.modules())
        bns = [mod for mod in net.modules() if isinstance(mod, BatchNorm)]
        assert {bn.momentum for bn in bns if bn in backbone} == {m}, name
        assert {bn.momentum for bn in bns if bn not in backbone} == {0.99}
    net = build_network("yolo_mobilev2", IN_HW, NANCHORS, CLASSES,
                        alpha=0.75).train()
    bn = net.backbone.block_5.project.bn
    seen = {}
    bn.register_forward_pre_hook(
        lambda mod, args: seen.setdefault("x", args[0].detach().clone()))
    before = bn.running_mean.clone() + 0.5
    bn.running_mean.copy_(before)
    with torch.no_grad():
        net(to_t(images(2)[0]).float() / 255)
    batch = seen["x"].mean(dim=(0, 2, 3))
    after = bn.running_mean
    assert torch.equal(after, 0.999 * before + (1 - 0.999) * batch)
    # the step itself, to the rounding of a subtraction near 0.5
    np.testing.assert_allclose((after - before).numpy(),
                               (0.001 * (batch - before)).numpy(),
                               rtol=1e-4, atol=2 ** -23)


@pytest.mark.parametrize("witness", ["smooth", "as_built"])
def test_train_mode_matches_jax(witness, monkeypatch):
    """alpha 0.75, B=4, fp32: the head outputs, the running statistics
    (momentum 0.999) and the gradient of every parameter against
    ``jax.vjp`` of ``apply(train=True)`` with the same cotangent.  The
    project convs' BN biases feed a 1x1 conv and a train-mode BN, so their
    gradient is 0."""
    smooth = witness == "smooth"
    res = train_mode_vs_jax("yolo_mobilev2", IN_HW, NANCHORS, CLASSES, 0.75,
                            monkeypatch=monkeypatch if smooth else None)
    assert len(res["moves"][1]) == 2 * (52 + 3)    # backbone and head BNs
    assert_train_mode_close(res, smooth, out_limit=3e-4, move_limit=5e-4,
                            vanishing=("project/bn/bias",))

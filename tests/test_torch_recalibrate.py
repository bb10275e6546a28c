"""The port's ``recalibrate_batch_stats`` against the JAX package's, on
yolo_mobilev2 (every backbone BN at momentum 0.999) and yolo_mobilev1
(0.99), at 64x96 with the weights of ``torch_parity.jax_weights``.

Tolerance: each statistic within 3e-4 of its largest JAX entry of JAX's
(``torch_parity.assert_close_to_jax``); measured at most 8.6e-5 (v2) and
9.7e-6 (v1).  JAX's error has two parts: the batch statistics' rounding,
amplified through the train-mode BatchNorms, and its momentum probe: it
divides by ``1 - m``, m found as the difference of two fp32 statistics
near 1, which is off by a few fp32 ulps of 1, up to 1e-4 relative at
m = 0.999.  The port sets every momentum to 0 for its forwards, so its
distance from its own float64 recalibration stays within twice JAX's
(measured 0.4x at most).  A recalibration that left the EMA in place or
kept the momenta misses by far more than the limit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from k210_yolo_framework_tpu.data.pipeline import HostBatch as JHostBatch
from k210_yolo_framework_tpu.training import train as JT
from k210_yolo_framework_tpu_torch.data.pipeline import HostBatch
from k210_yolo_framework_tpu_torch.models.layers import BatchNorm
from k210_yolo_framework_tpu_torch.training import checkpoint as TC
from k210_yolo_framework_tpu_torch.training import train as TT

from torch_parity import (
    assert_close_to_jax,
    jax_weights,
    port_net,
    stats_flat,
)

torch.set_num_threads(1)

IN_HW, NANCHORS, CLASSES = (64, 96), 3, 3
LIMIT = 3e-4


def _batches(seed, n, b=3):
    """n batches of 72x100 canvases as (canvases, img_hws, boxes, valid)."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (b, 72, 100, 3)).astype(np.uint8),
             np.tile(np.array([72, 100], np.int32), (b, 1)),
             np.zeros((b, 4, 5), np.float32), np.zeros((b, 4), bool))
            for _ in range(n)]


@pytest.mark.parametrize("name,alpha,momentum",
                         [("yolo_mobilev2", 0.75, 0.999),
                          ("yolo_mobilev1", 0.25, 0.99)])
def test_recalibrate_batch_stats_matches_jax(name, alpha, momentum):
    """Three batches through the same preprocess on each side (a crop of
    the canvases over 255: the same arithmetic in both), then every
    recalibrated statistic against the JAX package's; the net's mode and
    the EMA statistics it came with are replaced, not kept."""
    jnet, variables, flat = jax_weights(name, IN_HW, NANCHORS, CLASSES,
                                        alpha, seed=1)
    batches = _batches(7, 3)

    def jax_pp(c, hw, b, v, key):
        return c[:, :IN_HW[0], :IN_HW[1]].astype(jnp.float32) / 255, None

    def port_pp(c, hw, b, v, generator=None):
        return c[:, :IN_HW[0], :IN_HW[1]].to(torch.float32) / 255, None

    want = stats_flat(JT.recalibrate_batch_stats(
        jnet, variables["params"], variables["batch_stats"],
        iter(JHostBatch(*b) for b in batches), jax_pp,
        jax.random.PRNGKey(0), num_batches=3))
    net = port_net(name, IN_HW, NANCHORS, CLASSES, alpha, flat)
    backbone = set(net.backbone.modules())
    assert {m.momentum for m in net.modules()
            if isinstance(m, BatchNorm) and m in backbone} == {momentum}
    net64 = port_net(name, IN_HW, NANCHORS, CLASSES, alpha, flat).double()
    for n, dtype in ((net, torch.float32), (net64, torch.float64)):
        out = TT.recalibrate_batch_stats(
            n, iter(HostBatch(*b) for b in batches),
            lambda *a: (port_pp(*a)[0].to(dtype), None), num_batches=3,
            device="cpu", compute_dtype=dtype)
        assert out is n and not n.training
    got = TC.flat_from_state_dict(net.state_dict())
    exact = TC.flat_from_state_dict(net64.state_dict())
    assert sorted(want) == sorted(k for k in got if k.startswith("batch_"))
    for k, v in want.items():
        # the EMA was replaced, on both sides
        assert not np.allclose(v, flat[k]) and not np.allclose(got[k], flat[k]), k
        assert_close_to_jax(got[k], v, exact[k], LIMIT, k)


def test_recalibrate_leaves_the_statistics_when_a_batch_fails():
    _, _, flat = jax_weights("yolo_mobilev1", IN_HW, NANCHORS, CLASSES, 0.25,
                             seed=1)
    net = port_net("yolo_mobilev1", IN_HW, NANCHORS, CLASSES, 0.25, flat)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    batches = iter([HostBatch(*_batches(7, 1)[0])])   # one of two
    with pytest.raises(StopIteration):
        TT.recalibrate_batch_stats(
            net, batches, lambda c, *a: (c[:, :64, :96].float() / 255, None),
            num_batches=2, device="cpu")
    assert not net.training
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k]), k

"""Port yolo_mobilev1 (torch) and its weight bridge against the JAX net.

Both nets run the same weights: the JAX net's init, with BN statistics,
BN affine terms and head biases redrawn from a numpy seed so that no layer
is an identity, carried across with ``training/checkpoint.py``.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from k210_yolo_framework_tpu.models import layers as JL
from k210_yolo_framework_tpu.training.checkpoint import _flatten, save_h5
from k210_yolo_framework_tpu_torch.models import build_network
from k210_yolo_framework_tpu_torch.models import layers as TL
from k210_yolo_framework_tpu_torch.models.layers import Conv
from k210_yolo_framework_tpu_torch.training import checkpoint as TC

import shared

torch.set_num_threads(1)

# the small parity config: 2x3 and 4x6 grids at 64x96 input
SMALL = dict(in_hw=(64, 96), nanchors=3, class_num=3, alpha=0.25)


@functools.lru_cache(maxsize=None)
def jax_net_and_flat(seed: int = 0):
    """(JAX net, JAX variables, native flat dict) for the small config."""
    jnet, variables = shared.net_and_vars(
        "yolo_mobilev1", SMALL["in_hw"], SMALL["nanchors"], SMALL["class_num"],
        alpha=SMALL["alpha"])
    rng = np.random.default_rng(seed)
    flat = {}
    for group in ("params", "batch_stats"):
        for key, leaf in sorted(_flatten(variables[group]).items()):
            a = np.asarray(leaf, np.float32)
            if key.endswith(("/mean", "/bias")):
                a = rng.normal(0, 0.1, a.shape).astype(np.float32)
            elif key.endswith(("/var", "/scale")):
                a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
            flat[f"{group}/{key}"] = a
    return jnet, _unflatten(flat), flat


def _unflatten(flat):
    out = {}
    for key, a in flat.items():
        *path, leaf = key.split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = jnp.asarray(a)
    return out


def torch_net(flat=None):
    net = build_network("yolo_mobilev1", SMALL["in_hw"], SMALL["nanchors"],
                        SMALL["class_num"], alpha=SMALL["alpha"])
    if flat is not None:
        net.load_state_dict(TC.state_dict_from_flat(flat, net))
    return net.eval()


def test_bridge_round_trip_is_bit_exact():
    _, _, flat = jax_net_and_flat()
    back = TC.flat_from_state_dict(TC.state_dict_from_flat(flat, torch_net()))
    assert sorted(back) == sorted(flat)
    for k in flat:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], flat[k])


def test_bridge_layouts():
    _, _, flat = jax_net_and_flat()
    sd = TC.state_dict_from_flat(flat)
    k = flat["params/backbone/block_3/dw/conv/kernel"]          # [3, 3, 1, C]
    w = sd["backbone.block_3.dw.conv.weight"]                    # [C, 1, 3, 3]
    assert w.shape == (k.shape[3], 1, 3, 3)
    np.testing.assert_array_equal(w[:, 0].numpy(), k[:, :, 0].transpose(2, 0, 1))
    np.testing.assert_array_equal(
        sd["head.y1_out.dark_conv_out.bias"].numpy(),
        flat["params/head/y1_out/dark_conv_out/bias"])
    np.testing.assert_array_equal(
        sd["backbone.stem.bn.running_var"].numpy(),
        flat["batch_stats/backbone/stem/bn/var"])


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_bridge_rejects_mismatches(fault):
    _, _, flat = jax_net_and_flat()
    flat = dict(flat)
    if fault == "missing":
        del flat["params/backbone/stem/bn/scale"]
        err = KeyError
    elif fault == "extra":
        flat["params/backbone/stem2/conv/kernel"] = np.zeros((3, 3, 3, 8),
                                                             np.float32)
        err = KeyError
    else:
        flat["params/head/y2_out/dark_conv_out/bias"] = np.zeros(7, np.float32)
        err = ValueError
    with pytest.raises(err):
        TC.state_dict_from_flat(flat, torch_net())


def test_load_h5_and_npz_match_flat(tmp_path):
    jnet, variables, flat = jax_net_and_flat()
    want = TC.state_dict_from_flat(flat)
    save_h5(str(tmp_path / "w.h5"), variables)
    np.savez(tmp_path / "w.npz", **flat)
    net = torch_net()
    for sd in (TC.load_h5(str(tmp_path / "w.h5"), net),
               TC.load_npz(str(tmp_path / "w.npz"), net)):
        assert list(sd) == list(want)
        for k in want:
            assert torch.equal(sd[k], want[k])


def test_forward_matches_jax_fp32():
    """Same bridged weights, fp32, B=2, per head output.  Tolerance 1e-5
    abs + rel: the two sides sum the convs in different orders (measured
    difference ~4e-7 on outputs of magnitude ~0.5)."""
    jnet, variables, flat = jax_net_and_flat()
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, (2, *SMALL["in_hw"], 3)).astype(np.uint8)
    scale = (1.0 / x.reshape(2, -1).max(1)).astype(np.float32)
    want = jnet.apply(variables, jnp.asarray(x), input_scale=jnp.asarray(scale))
    with torch.inference_mode():
        got = torch_net(flat)(torch.from_numpy(x),
                              input_scale=torch.from_numpy(scale))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape == (2, *w.shape[1:3], 3, 8)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_forward_raw_layout():
    """Raw outputs are NHWC with channel a * (5 + C) + e."""
    net = torch_net()
    x = torch.zeros((1, *SMALL["in_hw"], 3))
    with torch.inference_mode():
        raw = net.forward_raw(x)
        view = net(x)
    assert [tuple(r.shape) for r in raw] == [(1, 2, 3, 24), (1, 4, 6, 24)]
    for r, v in zip(raw, view):
        assert torch.equal(r[0, 1, 2, 8 + 4], v[0, 1, 2, 1, 4])


def test_build_network_names_unported_builders():
    for name in ("yolo_mobilev2", "tiny_yolo", "yolo"):
        with pytest.raises(NotImplementedError, match=name):
            build_network(name, (224, 320), 3, 20)
    with pytest.raises(KeyError):
        build_network("resnet", (224, 320), 3, 20)


def test_demo_net_size_and_init():
    """The demo config has the JAX net's 94 param leaves, 60 batch-stat
    leaves and 3,856,838 parameters; the init follows flax's
    initialisers and is reproducible from the generator."""
    net = build_network("yolo_mobilev1", (224, 320), 3, 20, alpha=0.75,
                        generator=torch.Generator().manual_seed(1))
    assert len(list(net.parameters())) == 94
    assert len(list(net.buffers())) == 60
    assert sum(p.numel() for p in net.parameters()) == 3_856_838
    again = build_network("yolo_mobilev1", (224, 320), 3, 20, alpha=0.75,
                          generator=torch.Generator().manual_seed(1))
    for (k, a), b in zip(net.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
    for mod in net.modules():
        if isinstance(mod, Conv):
            std = (1.0 / mod.weight[0].numel()) ** 0.5 / 0.87962566103423978
            assert mod.weight.abs().max() <= 2 * std
            if mod.bias is not None:
                assert not mod.bias.any()
    sd = net.state_dict()
    assert torch.equal(sd["backbone.stem.bn.running_var"], torch.ones(24))
    assert not sd["backbone.stem.bn.running_mean"].any()


@pytest.mark.parametrize("name", ["relu6", "leaky_relu", "upsample2x"])
def test_layer_functions_match_jax(name):
    """The port's functions run on NCHW; the JAX ones on NHWC."""
    x = np.random.default_rng(5).normal(0, 4, (2, 3, 4, 5)).astype(np.float32)
    x[0, 0, 0, 0] = np.nan
    jx, tx = jnp.asarray(x), torch.from_numpy(x).permute(0, 3, 1, 2)
    if name == "relu6":
        want, got = JL.relu6(jx), TL.relu6(tx)
    elif name == "leaky_relu":
        want, got = JL.leaky_relu(0.3)(jx), TL.leaky_relu(0.3)(tx.clone())
    else:
        want, got = JL.upsample2x(jx), TL.upsample2x(tx)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


def test_darknet_conv_bn_stride2_matches_flax():
    """The stride-2 DarknetConvBN pads top/left only (the darknet
    builders' downsampling); flax and the port agree on the same weights."""
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (2, 9, 11, 6)).astype(np.float32)
    mod = JL.DarknetConvBN(features=8, kernel=(3, 3), strides=(2, 2))
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    flat = {}
    for group in ("params", "batch_stats"):
        for key, leaf in _flatten(variables[group]).items():
            a = np.asarray(leaf, np.float32)
            if key.endswith(("/mean", "/bias")):
                a = rng.normal(0, 0.1, a.shape).astype(np.float32)
            elif key.endswith(("/var", "/scale")):
                a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
            flat[f"{group}/{key}"] = a
    want = mod.apply(_unflatten(flat), jnp.asarray(x))
    port = TL.DarknetConvBN(6, 8, (3, 3), (2, 2))
    port.load_state_dict(TC.state_dict_from_flat(flat, port))
    with torch.inference_mode():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert tuple(got.shape) == (2, 8, 4, 5)   # (9 + 1 - 3) // 2 + 1, (11 + 1 - 3) // 2 + 1
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)

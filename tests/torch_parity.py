"""Weights for holding a port builder to its JAX twin, without a JAX init.

``jax_weights`` takes the JAX net's variable shapes from ``jax.eval_shape``
(no init is compiled or run, which for darknet53 would cost many seconds)
and draws every leaf from a numpy seed: conv kernels N(0, 1 / fan_in),
flax's lecun-normal scale; conv biases, BN biases and running means
N(0, 0.1); BN scales and running variances U(0.5, 1.5), so that no layer
is an identity.  The same flat dict goes to
both packages: to flax through ``unflatten``, to the port through
``training/checkpoint.py``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from k210_yolo_framework_tpu.models import build_network as jax_build
from k210_yolo_framework_tpu.training.checkpoint import _path_key
from k210_yolo_framework_tpu_torch.models import build_network
from k210_yolo_framework_tpu_torch.models.layers import smooth_witness
from k210_yolo_framework_tpu_torch.training import checkpoint as TC


def draw_flat(shapes, seed: int):
    """{'params/...' | 'batch_stats/...': array} drawn for the shape tree
    ``shapes`` (a variables dict of arrays or ShapeDtypeStructs)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for group in ("params", "batch_stats"):
        leaves = jax.tree_util.tree_flatten_with_path(shapes[group])[0]
        for path, leaf in sorted(leaves, key=lambda kv: _path_key(kv[0])):
            key, shape = _path_key(path), tuple(leaf.shape)
            if key.endswith("/kernel"):
                a = rng.standard_normal(shape, np.float32) * np.float32(
                    np.sqrt(1.0 / np.prod(shape[:-1])))
            elif key.endswith(("/mean", "/bias")):
                a = rng.standard_normal(shape, np.float32) * np.float32(0.1)
            else:                                   # scale, var
                a = rng.random(shape, np.float32) + np.float32(0.5)
            flat[f"{group}/{key}"] = a
    return flat


def unflatten(flat):
    out = {}
    for key, a in flat.items():
        *path, leaf = key.split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = jnp.asarray(a)
    return out


@functools.lru_cache(maxsize=None)
def jax_weights(name: str, in_hw, nanchors: int, class_num: int,
                alpha: float = 1.0, seed: int = 0):
    """(JAX net, its variables, the native flat dict); cached per process:
    treat as read-only."""
    jnet = jax_build(name, in_hw, nanchors, class_num, alpha=alpha)
    x = jnp.zeros((1, *in_hw, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda: jnet.module.init(jax.random.PRNGKey(0), x, train=False))
    flat = draw_flat(shapes, seed)
    return jnet, unflatten(flat), flat


def port_net(name: str, in_hw, nanchors: int, class_num: int,
             alpha: float = 1.0, flat=None):
    """The port's builder, with ``flat`` loaded when given, in eval mode."""
    net = build_network(name, in_hw, nanchors, class_num, alpha=alpha)
    if flat is not None:
        net.load_state_dict(TC.state_dict_from_flat(flat, net))
    return net.eval()


def params_flat(tree):
    """A params (or gradients) tree -> {'params/...': array}."""
    return {f"params/{_path_key(p)}": np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def stats_flat(tree):
    return {f"batch_stats/{_path_key(p)}": np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def to_t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---- bf16 forward --------------------------------------------------------

def bf16_errors(name, in_hw, nanchors, class_num, alpha, x_u8, scale):
    """Summed over every head output: (the port's bf16 program against the
    port's float64 forward, JAX's bf16 program against the same, port
    against JAX), each a total absolute difference.  The float64 forward is
    the exact function both bf16 programs round."""
    jnet, variables, flat = jax_weights(name, in_hw, nanchors, class_num,
                                        alpha)
    j16 = jax_build(name, in_hw, nanchors, class_num, alpha=alpha,
                    dtype=jnp.bfloat16)
    want = jax.jit(lambda v, a, s: j16.apply(v, a, input_scale=s))(
        variables, jnp.asarray(x_u8), jnp.asarray(scale))
    net = port_net(name, in_hw, nanchors, class_num, alpha, flat)
    with torch.inference_mode():
        got = net(to_t(x_u8), input_scale=to_t(scale), dtype=torch.bfloat16)
        assert all(g.dtype == torch.bfloat16 for g in got)
        exact = net.double()(to_t(x_u8).double(),
                             input_scale=to_t(scale).double(),
                             dtype=torch.float64)
    port_err = jax_err = apart = 0.0
    for g, w, r in zip(got, want, exact):
        assert w.dtype == jnp.bfloat16 and g.shape == w.shape
        g, w, r = g.double().numpy(), np.asarray(w, np.float64), r.numpy()
        port_err += np.abs(g - r).sum()
        jax_err += np.abs(w - r).sum()
        apart += np.abs(g - w).sum()
    return port_err, jax_err, apart


# ---- train mode ----------------------------------------------------------

def smooth_jax(monkeypatch):
    """The JAX package's side of ``layers.smooth_witness(net, pools=False)``:
    its ``leaky_relu(a)`` and MobileNetV2's ``relu6`` (a = 0) patched to
    a * x + (1 - a) * softplus(x) for this test."""
    from k210_yolo_framework_tpu.models import layers as JL
    from k210_yolo_framework_tpu.models import mobilenet_v2 as JV2

    monkeypatch.setattr(JL, "leaky_relu", lambda a: (
        lambda x: a * x + (1 - a) * jax.nn.softplus(x)))
    monkeypatch.setattr(JV2, "relu6", jax.nn.softplus)


def assert_close_to_jax(got, want, exact, limit, name=""):
    """Hold the port's fp32 ``got`` to the JAX package's fp32 ``want``:
    ``max|got - want| <= limit * max|want|``, ``limit`` a fixed bound set
    where it is called from sound runs, so that no difference between the
    two widens its own tolerance.  ``exact``, the port's float64 result,
    also holds the port's rounding to JAX's: ``max|got - exact|`` at most
    twice ``max|want - exact|`` plus 1e-6 of ``max|exact|``."""
    got, want, exact = (np.asarray(a, np.float64) for a in (got, want, exact))
    apart = np.abs(got - want).max()
    noise, own = np.abs(want - exact).max(), np.abs(got - exact).max()
    assert apart <= limit * np.abs(want).max(), (
        f"{name}: port-JAX {apart:.3g} over {limit:g} of "
        f"{np.abs(want).max():.3g}")
    assert own <= 2 * noise + 1e-6 * np.abs(exact).max(), (
        f"{name}: port-exact {own:.3g}, JAX-exact {noise:.3g}")


def train_mode_vs_jax(name, in_hw, nanchors, class_num, alpha, batch=4,
                      seed=5, monkeypatch=None):
    """One train-mode forward and backward on each side from the same
    weights, images U(0, 1) and output cotangents, and the port's forward
    in float64; with ``monkeypatch``, on the smooth witness
    (``smooth_witness`` with the pools kept, ``smooth_jax``).  Returns a
    dict of numpy results: the outputs (``out``: port, JAX, exact), the
    moves of the running statistics, each new value less the drawn one
    (``moves``: port, JAX, exact; a move is ``1 - m`` of batch less
    running, so it shows a wrong momentum or batch moment undiluted by
    ``m``), and the gradients (``grads``: port, JAX); moves and grads keyed
    by the native paths."""
    jnet, variables, flat = jax_weights(name, in_hw, nanchors, class_num,
                                        alpha)
    net, net64 = (port_net(name, in_hw, nanchors, class_num, alpha, flat)
                  .train() for _ in range(2))
    net64.double()
    if monkeypatch is not None:
        smooth_jax(monkeypatch)
        net, net64 = (smooth_witness(n, pools=False) for n in (net, net64))
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (batch, *in_hw, 3)).astype(np.float32)
    got = net(to_t(x))
    with torch.no_grad():
        exact = net64(to_t(x).double(), dtype=torch.float64)
    cts = [rng.normal(0, 1, tuple(g.shape)).astype(np.float32) for g in got]

    @jax.jit
    def fwd_bwd(params, xx, ct):
        def f(p):
            return jnet.apply({"params": p,
                               "batch_stats": variables["batch_stats"]},
                              xx, train=True)
        outs, vjp, upd = jax.vjp(f, params, has_aux=True)
        return outs, upd["batch_stats"], vjp(ct)[0]

    want, upd, grads = fwd_bwd(variables["params"], jnp.asarray(x),
                               [jnp.asarray(c) for c in cts])
    torch.autograd.backward(got, [to_t(c) for c in cts])

    def moves(stats):
        return {k: np.asarray(v, np.float64) - flat[k]
                for k, v in stats.items() if k.startswith("batch_stats/")}

    return {"out": ([g.detach().numpy() for g in got],
                    [np.asarray(w) for w in want],
                    [e.numpy() for e in exact]),
            "moves": tuple(moves(st) for st in (
                TC.flat_from_state_dict(net.state_dict()), stats_flat(upd),
                TC.flat_from_state_dict(net64.state_dict()))),
            "grads": (TC.flat_from_state_dict(
                {n: p.grad for n, p in net.named_parameters()}),
                params_flat(grads))}


def assert_train_mode_close(res, smooth, out_limit, move_limit, vanishing=()):
    """Hold ``train_mode_vs_jax``'s results: each output and each move of a
    running statistic by ``assert_close_to_jax`` at ``out_limit`` and
    ``move_limit``; on the smooth witness every gradient within 1e-3 of
    the largest entry of its own, except the parameters named by a suffix
    in ``vanishing``, whose exact gradient is 0 (a BN bias followed by a
    1x1 conv and a train-mode BN, which removes any per-channel shift): on
    both sides those stay below 1e-6 of the largest gradient entry."""
    for i, (g, w, e) in enumerate(zip(*res["out"])):
        assert g.shape == w.shape == e.shape
        assert_close_to_jax(g, w, e, out_limit, f"output {i}")
    moves, want_moves, exact_moves = res["moves"]
    assert sorted(moves) == sorted(want_moves)
    for k, w in want_moves.items():
        assert np.abs(w).max() > 0, k
        assert_close_to_jax(moves[k], w, exact_moves[k], move_limit, k)
    grads, want_grads = res["grads"]
    assert sorted(grads) == sorted(want_grads)
    if not smooth:
        return
    top = max(np.abs(w).max() for w in want_grads.values())
    for k, w in want_grads.items():
        if k.endswith(tuple(vanishing)):
            assert max(np.abs(w).max(), np.abs(grads[k]).max()) <= 1e-6 * top
            continue
        scale = np.abs(w).max()
        assert scale > 0, k
        np.testing.assert_allclose(grads[k], w, rtol=0, atol=1e-3 * scale,
                                   err_msg=k)

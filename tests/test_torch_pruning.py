"""The port's magnitude pruning against the JAX package's
(``training/pruning.py`` and the pruned train step).

The sparsity schedule is held bit for bit to JAX's expression evaluated op
by op.  Under ``jax.jit`` XLA on the CPU rewrites it (the division by the
constant span becomes a product with its reciprocal, and the last
multiply-add is fused), which moves the result by up to a few ulps; the
jitted value is held to a model of those rewrites bit for bit, and to the
port's within 4 ulps.  The quantile threshold is held bit for bit
to ``jnp.quantile`` (always jitted: XLA fuses its blend into one
multiply-add, which the port computes exactly), so masks match mask for
mask, ties planted at the threshold included.

A pruned trajectory drifts as the unpruned one does
(``test_torch_train.py``: the first step's losses rtol 1e-5, later ones
1e-3); a weight whose magnitude lies within 1e-4 of its kernel's threshold,
or within the drift of the weight and the threshold, may then land on the
other side of it, so masks are held equal except at such weights, which
are counted.  A flipped weight moves by about the threshold itself, so
before the next step each flipped entry takes JAX's side (mask and
weight); from the same weights the port's masks equal JAX's exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from k210_yolo_framework_tpu import config as JConfig
from k210_yolo_framework_tpu.models import build_network as jax_build
from k210_yolo_framework_tpu.training import metrics as JM
from k210_yolo_framework_tpu.training import pruning as JP
from k210_yolo_framework_tpu.training import train as JT
from k210_yolo_framework_tpu.training.checkpoint import _flatten
from k210_yolo_framework_tpu_torch import config as TConfig
from k210_yolo_framework_tpu_torch.models.yolonet import NETWORKS
from k210_yolo_framework_tpu_torch.training import checkpoint as TC
from k210_yolo_framework_tpu_torch.training import pruning as TP
from k210_yolo_framework_tpu_torch.training import train as TT

from test_torch_model import jax_net_and_flat, torch_net
from test_torch_predictor import JSPEC, TSPEC
from test_torch_train import _batch, _t

torch.set_num_threads(1)

_jax_update_masks = jax.jit(JP.update_masks)
_jax_sparsity_of = jax.jit(JP.sparsity_of)


# ---- the schedule ---------------------------------------------------------

@pytest.mark.parametrize("initial,final,begin,end", [
    (0.5, 0.9, 0, 600),      # the CLI's defaults at 120 steps an epoch
    (0.3, 0.8, 0, 6),
    (0.1, 0.95, 0, 333),
    (0.2, 0.7, 3, 3),        # begin == end: span max(0, 1) = 1
])
def test_polynomial_sparsity_matches_jax(initial, final, begin, end):
    jitted = jax.jit(lambda s: JP.polynomial_sparsity(s, initial, final,
                                                      begin, end))
    for step in range(0, end + 5):
        got = TP.polynomial_sparsity(step, initial, final, begin, end)
        assert isinstance(got, np.float32)
        eager = np.float32(JP.polynomial_sparsity(
            jnp.float32(step), initial, final, begin, end))
        assert got == eager, (step, got, eager)
        jit = np.float32(jitted(jnp.float32(step)))
        assert jit == _xla_cpu_sparsity(step, initial, final, begin, end)
        assert abs(got - jit) <= 4 * np.spacing(np.float32(max(got, jit)))


def _xla_cpu_sparsity(step, initial, final, begin, end):
    """The schedule as XLA on the CPU compiles it under jit: the division
    by the constant span as a product with the fp32 reciprocal, and
    ``final + c * x`` as one fused multiply-add."""
    f32 = np.float32
    p = (f32(step) - f32(begin)) * f32(1.0 / max(end - begin, 1))
    p = min(max(p, f32(0.0)), f32(1.0))
    x = f32(1.0) - p
    return f32(np.float64(f32(initial - final)) * np.float64(x * x * x)
               + np.float64(f32(final)))


# ---- masks ----------------------------------------------------------------

# (name, HWIO shape): dense, depthwise and 1x1 kernels, and a BN scale
_SHAPES = {"a.conv": (3, 3, 8, 16), "b.dw": (3, 3, 1, 24),
           "c.pw": (1, 1, 24, 40), "d.out": (1, 1, 40, 7)}


def _kernels(seed, sparsity):
    """HWIO kernels drawn from a seed, each with a run of ties planted at
    the rank its ``sparsity`` quantile reads."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in _SHAPES.items():
        w = rng.normal(0, 1, shape).astype(np.float32)
        flat = w.reshape(-1)
        n = flat.size
        rank = int(np.floor(np.float32(sparsity) * np.float32(n - 1)))
        v = np.sort(np.abs(flat))[rank]
        idx = rng.choice(n, 7, replace=False)
        flat[idx] = v * rng.choice([-1.0, 1.0], 7).astype(np.float32)
        out[name] = w
    return out


def _jax_tree(kernels, scale):
    tree = {}
    for name, w in kernels.items():
        a, b = name.split(".")
        tree.setdefault(a, {})[b] = {"kernel": jnp.asarray(w)}
    tree["bn"] = {"scale": jnp.asarray(scale)}
    return tree


def _port_params(kernels, scale):
    params = {f"{name}.weight": torch.from_numpy(
        np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
        for name, w in kernels.items()}
    params["bn.weight"] = torch.from_numpy(scale)
    return params


def _port_masks_hwio(masks):
    return {n[:-len(".weight")]: m.permute(2, 3, 1, 0).numpy()
            for n, m in masks.items()}


@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.9, 1.0])
def test_update_masks_matches_jax_mask_for_mask(sparsity):
    ties = 0
    for seed in range(6):
        kernels = _kernels(seed, sparsity)
        scale = np.random.default_rng(seed).uniform(
            0.5, 1.5, (5,)).astype(np.float32)
        tree = _jax_tree(kernels, scale)
        want = _jax_update_masks(tree, JP.init_masks(tree),
                                 jnp.float32(sparsity))
        params = _port_params(kernels, scale)
        masks = {n: torch.ones_like(p) for n, p in params.items()
                 if TP.is_prunable(n, p)}
        assert sorted(masks) == sorted(f"{n}.weight" for n in _SHAPES)
        got = _port_masks_hwio(TP.update_masks(params, masks, sparsity))
        for name, w in kernels.items():
            a, b = name.split(".")
            np.testing.assert_array_equal(got[name],
                                          np.asarray(want[a][b]["kernel"]),
                                          err_msg=f"{name} seed {seed}")
            thr = np.float32(jnp.quantile(jnp.abs(jnp.asarray(w)).ravel(),
                                          jnp.float32(sparsity)))
            ties += int(np.sum(np.abs(w) == thr))
        assert np.asarray(want["bn"]["scale"]).shape == ()
        # op by op, as JAX defines it (under jit XLA multiplies by the
        # reciprocal of the constant count, an ulp away at times)
        got_s = TP.sparsity_of(TP.update_masks(params, masks, sparsity))
        assert got_s.dtype == torch.float32
        assert float(got_s) == float(JP.sparsity_of(tree, want))
        np.testing.assert_allclose(float(got_s),
                                   float(_jax_sparsity_of(tree, want)),
                                   rtol=2 ** -23, atol=0)
    # the planted runs sit on the threshold in most kernels
    assert ties >= 7 * len(_SHAPES) * 6 // 2


def test_update_masks_nan_kernel_masks_all_like_jax():
    kernels = _kernels(3, 0.5)
    kernels["a.conv"][0, 0, 0, 0] = np.nan
    scale = np.ones((5,), np.float32)
    tree = _jax_tree(kernels, scale)
    want = _jax_update_masks(tree, JP.init_masks(tree), jnp.float32(0.5))
    params = _port_params(kernels, scale)
    masks = {n: torch.ones_like(p) for n, p in params.items()
             if TP.is_prunable(n, p)}
    got = _port_masks_hwio(TP.update_masks(params, masks, 0.5))
    assert not np.asarray(want["a"]["conv"]["kernel"]).any()
    for name in kernels:
        a, b = name.split(".")
        np.testing.assert_array_equal(got[name],
                                      np.asarray(want[a][b]["kernel"]))


def test_fma_blend_is_exact():
    """The threshold blend is one correctly rounded fp32 multiply-add:
    against exact rational arithmetic on values where a float64 sum would
    round twice."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    a = rng.uniform(0, 2, 4000).astype(np.float32)
    b = rng.uniform(0, 1, 4000).astype(np.float32)
    c = (rng.uniform(0, 2, 4000) * np.exp2(rng.integers(-40, 3, 4000))
         ).astype(np.float32)
    got = TP._fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                      torch.from_numpy(c)).numpy()
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(-np.inf)),
                 np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.int32))
                                         & 1))
        assert g == best, (x, y, z)


# ---- what is prunable ----------------------------------------------------

_BUILDERS = [("yolo_mobilev1", 0.5, ((3, 3), (6, 6))),
             ("yolo_mobilev2", 0.5, ((3, 3), (6, 6))),
             ("tiny_yolo", 1.0, ((3, 3), (6, 6))),
             ("yolo", 1.0, ((3, 3), (6, 6), (12, 12)))]


@pytest.mark.parametrize("name,alpha,grids", _BUILDERS,
                         ids=[b[0] for b in _BUILDERS])
def test_is_prunable_selects_jax_leaves(name, alpha, grids):
    """Through the bridge names, on every builder: the port's prunable
    parameters are exactly the leaves JAX's ``is_prunable`` selects."""
    jnet = jax_build(name, (96, 96), 3, 4, alpha=alpha)
    shapes = jax.eval_shape(lambda: jnet.module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 96, 96, 3)), train=False))
    want = sorted(
        "params/" + "/".join(str(getattr(p, "key", "")) for p in path)
        for path, leaf in jax.tree_util.tree_flatten_with_path(
            shapes["params"])[0] if JP.is_prunable(path, leaf))
    with torch.device("meta"):
        net = NETWORKS[name](anchor_num=3, class_num=4, in_hw=(96, 96),
                             alpha=alpha)
    got = sorted(TC.native_key(n, p.ndim) for n, p in net.named_parameters()
                 if TP.is_prunable(n, p))
    assert got == want and len(got) > 10
    assert all(k.endswith("/kernel") for k in got)


# ---- the pruned train step -----------------------------------------------

PCFG = dict(batch_size=4, init_learning_rate=1e-3, is_prune=True,
            prune_initial_sparsity=0.3, prune_final_sparsity=0.8,
            prune_end_epoch=1, prune_frequency=2)


def _jax_state(variables):
    tx = JT.make_optimizer(JConfig.TrainConfig(**PCFG))
    params = jax.tree.map(jnp.copy, variables["params"])
    return JT.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.copy, variables["batch_stats"]),
        opt_state=tx.init(params), masks=JP.init_masks(params),
        pr=JM.init_pr_state(2))


def _jax_masks(state):
    return {f"params/{k}": np.asarray(v)
            for k, v in _flatten(state.masks).items() if np.ndim(v) == 4}


def _sync_to_jax(state, jstate):
    """Load JAX's train state into the port's: weights, BN statistics,
    masks, Adam's moments and count, P/R counters and the step."""
    flat = {f"{g}/{k}": np.asarray(v) for g in ("params", "batch_stats")
            for k, v in _flatten(getattr(jstate, g)).items()}
    net = state.net
    net.load_state_dict(TC.state_dict_from_flat(flat, net))
    adam = jstate.opt_state[0]
    mu = {f"params/{k}": np.asarray(v) for k, v in _flatten(adam.mu).items()}
    nu = {f"params/{k}": np.asarray(v) for k, v in _flatten(adam.nu).items()}
    with torch.no_grad():
        for n, p in net.named_parameters():
            key = TC.native_key(n, p.ndim)
            st = state.optimizer.state[p]
            st["exp_avg"].copy_(TC.state_dict_from_flat({key: mu[key]})[n])
            st["exp_avg_sq"].copy_(TC.state_dict_from_flat({key: nu[key]})[n])
            st["step"].fill_(int(adam.count))
            if n in state.masks:
                state.masks[n].copy_(TC.state_dict_from_flat(
                    {key: _jax_masks(jstate)[key]})[n])
    state.sparsity = TP.sparsity_of(state.masks)
    state.pr = {k: torch.from_numpy(np.array(v)) for k, v in jstate.pr.items()}
    state.step = int(jstate.step)


def test_pruned_trajectory_matches_jax(monkeypatch):
    """Four steps from the same weights, masks updated at steps 0 and 2
    (prune_frequency 2, the schedule's end at step 3); the fourth step
    starts from JAX's state (a mask flipped at step 2 moves its weight by
    about the threshold, which shows in the next loss at 2-3e-3)."""
    jnet, variables, flat = jax_net_and_flat()
    jstate = _jax_state(variables)
    jstep = JT.make_train_step(jnet, JSPEC, JConfig.TrainConfig(**PCFG),
                               train_epoch_step=3)
    cfg = TConfig.TrainConfig(**PCFG)
    state = TT.create_train_state(torch_net(flat), cfg, "cpu")
    assert all(bool((m == 1).all()) for m in state.masks.values())
    step = TT.make_train_step(TSPEC, cfg, train_epoch_step=3)

    seen = []
    update = TP.update_masks

    def recording(params, masks, sparsity):
        seen.append(({n: p.detach().clone() for n, p in params.items()
                      if n in masks}, sparsity))
        return update(params, masks, sparsity)

    monkeypatch.setattr(TP, "update_masks", recording)
    # JAX's weights before masking: the same update without pruning
    jplain = JT.make_train_step(
        jnet, JSPEC, JConfig.TrainConfig(**{**PCFG, "is_prune": False}),
        train_epoch_step=3)
    flips = []
    for i, (seed, rtol) in enumerate(((30, 1e-5), (31, 1e-3), (32, 1e-3),
                                      (33, 1e-5))):
        if i == 3:
            # a flipped weight moves by about its threshold, far more than
            # the drift: the last step starts from JAX's state
            _sync_to_jax(state, jstate)
        images, labels = _batch(seed)
        jargs = (jnp.asarray(images), tuple(jnp.asarray(l) for l in labels))
        if i in (0, 2):
            jpre, _ = jplain(jax.tree.map(jnp.copy, jstate), *jargs)
            jpre = {f"params/{k}": np.asarray(v)
                    for k, v in _flatten(jpre.params).items()}
        jstate, jlogs = jstep(jstate, *jargs)
        state, logs = step(state, _t(images), [_t(l) for l in labels])
        assert sorted(logs) == sorted(jlogs)
        for k in ("loss", "l1_loss", "l2_loss"):
            np.testing.assert_allclose(float(logs[k]), float(jlogs[k]),
                                       rtol=rtol, err_msg=f"{k} step {i}")
        np.testing.assert_allclose(float(logs["sparsity"]),
                                   float(jlogs["sparsity"]), rtol=0,
                                   atol=1e-6)
        got = TC.flat_from_state_dict(state.masks)
        want = _jax_masks(jstate)
        assert sorted(got) == sorted(want)
        if i not in (0, 2):
            for key in got:
                np.testing.assert_array_equal(got[key], want[key])
            continue
        pre, sparsity = seen[-1]
        assert sparsity == TP.polynomial_sparsity(i, 0.3, 0.8, 0, 3)
        # from JAX's own weights the port's masks are JAX's, exactly
        names = list(pre)
        same = TC.flat_from_state_dict(update(
            {n: TC.state_dict_from_flat(
                {TC.native_key(n, 4): jpre[TC.native_key(n, 4)]})[n]
             for n in names}, {n: None for n in names}, sparsity))
        for key in same:
            np.testing.assert_array_equal(same[key], want[key], err_msg=key)
        # along the trajectory a mask differs only where the weight lies
        # within 1e-4 of its threshold, or no further from it than the
        # weight and the threshold drifted from JAX's
        def thresholds(ws):
            return TP._thresholds([torch.from_numpy(np.sort(np.abs(
                ws[TC.native_key(n, 4)]).reshape(-1))) for n in names],
                np.float32(sparsity)).numpy()

        mine = TC.flat_from_state_dict(pre)
        for n, t, tj in zip(names, thresholds(mine), thresholds(jpre)):
            key = TC.native_key(n, 4)
            diff = got[key] != want[key]
            w = mine[key][diff]
            rel = np.abs(np.abs(w) - t) / t
            drift = (np.abs(w - jpre[key][diff]) + abs(t - tj)) / t
            assert (rel <= np.maximum(1e-4, drift)).all(), (key, rel, drift)
            flips += [(float(r), float(d)) for r, d in zip(rel, drift)]
    assert len(seen) == 2 and state.step == int(jstate.step) == 4
    print(f"masks differing along the trajectory: {len(flips)} "
          f"(distance from the threshold / drift: {flips})")
    # measured: 22 of the small net's 985,328 prunable weights, two updates
    total = sum(m.numel() for m in state.masks.values())
    assert len(flips) <= 1e-4 * total, (len(flips), total)
    # pruned weights are exactly zero on both sides
    params = TC.flat_from_state_dict(dict(state.net.named_parameters()))
    jparams = {f"params/{k}": np.asarray(v)
               for k, v in _flatten(jstate.params).items()}
    for key, m in got.items():
        assert not params[key][m == 0].any()
        assert not jparams[key][want[key] == 0].any()


def test_pruned_weights_stay_zero_after_adam():
    """The counterpart of the JAX package's pruned-training test: eight
    steps, masks updated at steps 0, 2, 4 and 6 up to the schedule's end
    at step 6; Adam's moments are not masked, so only the mask applied
    after each update keeps the pruned weights at zero."""
    _, _, flat = jax_net_and_flat()
    cfg = TConfig.TrainConfig(**PCFG)
    state = TT.create_train_state(torch_net(flat), cfg, "cpu")
    step = TT.make_train_step(TSPEC, cfg, train_epoch_step=6)
    images, labels = _batch(40)
    history = []
    for _ in range(8):
        before = {n: m.clone() for n, m in state.masks.items()}
        state, logs = step(state, _t(images), [_t(l) for l in labels])
        history.append(any(not torch.equal(before[n], m)
                           for n, m in state.masks.items()))
    assert history == [True, False, True, False, True, False, True, False]
    assert float(logs["sparsity"]) > 0.7
    params = dict(state.net.named_parameters())
    moments = state.optimizer.state
    revived = 0
    for n, m in state.masks.items():
        assert not params[n][m == 0].any(), n
        revived += int((moments[params[n]]["exp_avg"][m == 0] != 0).sum())
    assert revived > 0   # the moments of pruned weights live on


def test_make_train_step_needs_the_epoch_length_to_prune():
    with pytest.raises(ValueError, match="train_epoch_step"):
        TT.make_train_step(TSPEC, dataclasses.replace(
            TConfig.TrainConfig(), is_prune=True))

"""The port's train step against the JAX package's, on the small parity
net of ``test_torch_model.py`` (alpha 0.25, 64x96 input, grids 2x3 / 4x6,
3 classes) with the same bridged weights.

Tolerances, each measured first:
* train-mode ConvBN: output and input gradient rtol/atol 1e-5 (sum order),
  running statistics rtol 1e-6;
* the loss terms and metrics on the same inputs: rtol 1e-5 (reduction
  order); the ignore mask and P/R counts exactly;
* the whole net in fp32: loss rtol 1e-5 (measured 5.4e-7); every
  parameter's gradient within 1e-3 of the largest entry of its own
  gradient.  A gradient goes back through as many as 29 train-mode
  BatchNorms whose batch statistics are summed in another order on each
  side; the measured worst was 5.6e-5 (a BN scale);
* Adam against optax: rtol 1e-6 / atol 1e-7, a ten-thousandth of a step
  (another rounding order; measured 1.6e-8);
* a 3-step trajectory: the first step's losses rtol 1e-5 (measured
  6.7e-7), the next two rtol 1e-3 (measured 2.1e-4).  Adam's first steps
  move every parameter by about +-lr whatever its gradient's size, so a
  tiny gradient that differs in sign flips a whole step, and the two
  trajectories drift apart step by step;
* bf16 compute: loss rtol 2e-2.  Both round each conv output to bf16, but
  in other places (the JAX stem is an im2col matmul), and a bf16 ulp is
  2^-8 relative.
"""

import dataclasses
import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from k210_yolo_framework_tpu import config as JConfig
from k210_yolo_framework_tpu.inference import Predictor as JaxPredictor
from k210_yolo_framework_tpu.models import build_network as jax_build
from k210_yolo_framework_tpu.models import layers as JL
from k210_yolo_framework_tpu.ops import codec as JC
from k210_yolo_framework_tpu.training import loss as JLoss
from k210_yolo_framework_tpu.training import metrics as JM
from k210_yolo_framework_tpu.training import pruning as JP
from k210_yolo_framework_tpu.training import train as JT
from k210_yolo_framework_tpu.training.checkpoint import _flatten
from k210_yolo_framework_tpu_torch import config as TConfig
from k210_yolo_framework_tpu_torch.data import pipeline as TPL
from k210_yolo_framework_tpu_torch.data.annotations import split_train_test
from k210_yolo_framework_tpu_torch.inference import (
    Predictor,
    stack_detections,
)
from k210_yolo_framework_tpu_torch.models import layers as TL
from k210_yolo_framework_tpu_torch.training import checkpoint as TC
from k210_yolo_framework_tpu_torch.training import loss as TLoss
from k210_yolo_framework_tpu_torch.training import metrics as TM
from k210_yolo_framework_tpu_torch.training import train as TT
from k210_yolo_framework_tpu_torch.utils.detmatch import (
    assert_detections_close,
)

from test_torch_model import SMALL, _unflatten, jax_net_and_flat, torch_net
from test_torch_predictor import JSPEC, THRESH, TSPEC, _scene

torch.set_num_threads(1)

# the same hyperparameters for each package: JCFG goes to JAX functions,
# CFG to the port's
JCFG = JConfig.TrainConfig(batch_size=4, init_learning_rate=1e-3)
CFG = TConfig.TrainConfig(batch_size=4, init_learning_rate=1e-3)
LOSS_ARGS = (CFG.obj_thresh, CFG.iou_thresh, CFG.obj_weight,
             CFG.noobj_weight, CFG.wh_weight)

# jitted JAX entry points: op-by-op they cost seconds per call
_jax_encode = jax.jit(lambda b, v: JC.encode_labels_batch(b, v, JSPEC))
_jax_loss_layers = jax.jit(
    lambda l, p: JLoss.yolo_loss_layers(l, p, JSPEC, 4, *LOSS_ARGS))
_jax_update_pr = jax.jit(JM.update_pr_state)


@functools.partial(jax.jit, static_argnums=2)
def _jax_ignore_mask(lab, pred, layer):
    pxy, pwh = JC.xywh_grid_to_all(pred[..., 0:2], pred[..., 2:4], layer,
                                   JSPEC)
    return pxy, pwh, jax.vmap(lambda yt, a, b: JLoss.calc_ignore_mask(
        yt, a, b, 0.7, 0.3))(lab, pxy, pwh)


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch(seed, b=4):
    """Images [b, 64, 96, 3] in [0, 1] and their per-layer labels."""
    rng = np.random.default_rng(seed)
    boxes = np.concatenate([rng.integers(0, 3, (b, 5, 1)),
                            rng.uniform(0.15, 0.85, (b, 5, 2)),
                            rng.uniform(0.1, 0.6, (b, 5, 2))], -1)
    boxes, valid = map(np.stack, zip(*(JC.pad_boxes(x) for x in boxes)))
    labels = [np.asarray(x) for x in _jax_encode(jnp.asarray(boxes),
                                                 jnp.asarray(valid))]
    images = rng.uniform(0, 1, (b, *SMALL["in_hw"], 3)).astype(np.float32)
    return images, labels


def _params_flat(grads_or_params):
    return {f"params/{k}": v for k, v in _flatten(grads_or_params).items()}


# ---- layers ---------------------------------------------------------------

def test_leaky_relu_gradient_at_zero_is_one():
    x = np.array([-1.5, -0.0, 0.0, 2.0, np.nan], np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.sum(JL.leaky_relu(0.1)(v)))(
        jnp.asarray(x)))
    xt = _t(x).requires_grad_()
    TL.leaky_relu(0.1)(xt).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), want)
    np.testing.assert_array_equal(
        want, np.array([0.1, 1.0, 1.0, 1.0, 0.1], np.float32))
    # ReLU: 0 at 0 in both
    xt = _t(x[:4]).requires_grad_()
    TL.relu(xt).sum().backward()
    np.testing.assert_array_equal(
        xt.grad.numpy(),
        np.asarray(jax.grad(lambda v: jnp.sum(fnn.relu(v)))(jnp.asarray(x[:4]))))


@pytest.mark.parametrize("x", [-1.0, 0.0, 3.0, 6.0, 7.0, np.nan])
def test_relu6_forward_and_gradient_match_jax(x):
    """JAX's ``minimum(relu(x), 6)``: gradient 0 at 0 (relu's) and 0.5 at 6
    (``minimum`` splits the tie); NaN stays NaN in the forward."""
    xs = np.array([x], np.float32)
    want_y = np.asarray(JL.relu6(jnp.asarray(xs)))
    xt = _t(xs).requires_grad_()
    y = TL.relu6(xt)
    np.testing.assert_array_equal(y.detach().numpy(), want_y)
    if np.isnan(x):
        assert np.isnan(want_y).all()
        return
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(JL.relu6(v)))(
        jnp.asarray(xs)))
    y.sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), want_g)
    expect = {-1.0: 0.0, 0.0: 0.0, 3.0: 1.0, 6.0: 0.5, 7.0: 0.0}[x]
    np.testing.assert_array_equal(want_g, [expect])


def test_inference_ops_stay_in_place_and_train_ops_do_not():
    """Without gradients the activations write into their input (serving);
    with gradients they leave it as it was."""
    x = torch.tensor([-2.0, 3.0])
    with torch.no_grad():
        TL.leaky_relu(0.5)(x)
    assert x.tolist() == [-1.0, 3.0]
    y = torch.tensor([-2.0, 3.0], requires_grad=True)
    out = TL.leaky_relu(0.5)(y * 1)
    assert out.tolist() == [-1.0, 3.0] and y.tolist() == [-2.0, 3.0]


def _randomized(variables, rng):
    flat = {}
    for group in variables:
        for key, leaf in _flatten(variables[group]).items():
            a = np.asarray(leaf, np.float32)
            if key.endswith(("/mean", "/bias")):
                a = rng.normal(0, 0.1, a.shape).astype(np.float32)
            elif key.endswith(("/var", "/scale")):
                a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
            flat[f"{group}/{key}"] = a
    return flat


@pytest.mark.parametrize("kind", ["dense", "depthwise"])
def test_train_mode_conv_bn_matches_flax(kind):
    """Output, new running statistics and the gradients of input and
    parameters against flax ``apply(train=True, mutable=["batch_stats"])``."""
    rng = np.random.default_rng(6)
    x = rng.normal(0.3, 1, (4, 9, 11, 6)).astype(np.float32)
    if kind == "dense":
        mod = JL.ConvBN(features=8, kernel=(3, 3), act=JL.leaky_relu(0.3))
        port = TL.ConvBN(6, 8, (3, 3), act=TL.leaky_relu(0.3))
    else:
        mod = JL.ConvBN(features=0, kernel=(3, 3), strides=(2, 2),
                        explicit_pad=((1, 1), (1, 1)), act=fnn.relu,
                        depthwise=True)
        port = TL.ConvBN(6, 6, (3, 3), (2, 2), explicit_pad=((1, 1), (1, 1)),
                         act=TL.relu, depthwise=True)
    flat = _randomized(jax.jit(mod.init)(jax.random.PRNGKey(0),
                                         jnp.asarray(x)), rng)
    variables = _unflatten(flat)

    def f(params, xx):
        return mod.apply({"params": params,
                          "batch_stats": variables["batch_stats"]}, xx,
                         train=True, mutable=["batch_stats"])

    @jax.jit
    def fwd_bwd(params, xx, ct):
        out, vjp, upd = jax.vjp(f, params, xx, has_aux=True)
        return out, upd, vjp(ct)

    out_shape = jax.eval_shape(f, variables["params"], jnp.asarray(x))[0]
    ct = rng.normal(0, 1, out_shape.shape).astype(np.float32)
    want, upd, (g_params, g_x) = fwd_bwd(variables["params"], jnp.asarray(x),
                                         jnp.asarray(ct))

    port.load_state_dict(TC.state_dict_from_flat(flat, port))
    port.train()
    xt = _t(x).permute(0, 3, 1, 2).requires_grad_()
    got = port(xt)
    got.backward(_t(ct).permute(0, 3, 1, 2))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), **tol)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(g_x), **tol)
    new_stats = _flatten(upd["batch_stats"])
    sd = port.state_dict()
    np.testing.assert_allclose(sd["bn.running_mean"].numpy(),
                               new_stats["bn/mean"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(sd["bn.running_var"].numpy(),
                               new_stats["bn/var"], rtol=1e-6, atol=1e-7)
    grads = TC.flat_from_state_dict({n: p.grad for n, p in
                                     port.named_parameters()})
    want_g = _params_flat(g_params)
    assert sorted(grads) == sorted(want_g)
    for k in grads:
        np.testing.assert_allclose(grads[k], want_g[k], rtol=1e-4,
                                   atol=1e-4 * np.abs(want_g[k]).max())


# ---- loss and metrics -----------------------------------------------------

def test_layer_loss_ignore_mask_and_metrics_match_jax():
    rng = np.random.default_rng(1)
    _, labels = _batch(1)
    preds = [rng.normal(0, 1.5, lab.shape).astype(np.float32) for lab in labels]
    preds[0][0, 0, 0, 0, :4] = [0.0, 0.0, 0.0, 0.0]   # logits at 0
    want = _jax_loss_layers(labels, preds)
    got = TLoss.yolo_loss_layers([_t(l) for l in labels],
                                 [_t(p) for p in preds], TSPEC, 4, *LOSS_ARGS)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    total = TLoss.yolo_loss([_t(l) for l in labels], [_t(p) for p in preds],
                            TSPEC, 4, *LOSS_ARGS)
    np.testing.assert_allclose(float(total), float(sum(want)), rtol=1e-5)

    for layer, (lab, pred) in enumerate(zip(labels, preds)):
        pxy, pwh, want_m = _jax_ignore_mask(lab, pred, layer)
        got_m = TLoss.calc_ignore_mask(_t(lab), _t(pxy), _t(pwh), 0.7, 0.3)
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
        assert 0 < float(got_m.mean()) < 1

    state_j, state_t = JM.init_pr_state(2), TM.init_pr_state(2)
    for _ in range(2):
        state_j = _jax_update_pr(state_j, labels, preds, 0.5)
        state_t = TM.update_pr_state(state_t, [_t(l) for l in labels],
                                     [_t(p) for p in preds], 0.5)
    for k in ("tp", "fp", "fn"):
        np.testing.assert_array_equal(state_t[k].numpy(),
                                      np.asarray(state_j[k]))
    for g, w in zip(TM.pr_results(state_t) + TM.pr_results_per_layer(state_t),
                    JM.pr_results(state_j) + JM.pr_results_per_layer(state_j)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    empty = TM.init_pr_state(2)
    assert [float(v) for v in TM.pr_results(empty)] == [0.0, 0.0]


def test_loss_gradient_at_zero_logit_splits_like_jax():
    """At a logit of exactly 0 the BCE's gradient is JAX's: ``max`` splits
    the tie and ``|x|`` has slope 1 (``torch.abs`` alone would give
    0.5 - label, not -label)."""
    lab = np.array([0.0, 1.0, 0.3], np.float32)
    logits = np.zeros(3, np.float32)
    want = jax.grad(lambda z: jnp.sum(JLoss._bce_logits(jnp.asarray(lab), z)))(
        jnp.asarray(logits))
    z = _t(logits).requires_grad_()
    TLoss._bce_logits(_t(lab), z).sum().backward()
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(want), rtol=1e-6)


def test_l2_penalty_same_kernels_and_value():
    """The same set of kernels (the head's Darknet convs, not the BN scales
    named ``weight`` beside them, nor the head biases) and its value."""
    _, variables, flat = jax_net_and_flat()
    want_keys = sorted(
        "params/" + "/".join(getattr(p, "key", "") for p in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(
            variables["params"])[0]
        if any("dark_conv" in str(getattr(p, "key", "")) for p in path)
        and getattr(path[-1], "key", "") == "kernel")
    net = torch_net(flat)
    got_keys = sorted(f"params/{name.replace('.', '/')}/kernel"
                      for name, _ in TLoss.l2_kernels(net))
    assert got_keys == want_keys and len(got_keys) == 5
    np.testing.assert_allclose(float(TLoss.l2_penalty(net).detach()),
                               float(JLoss.l2_penalty(variables["params"])),
                               rtol=1e-6)


# ---- the whole net --------------------------------------------------------

def _jax_loss_fn(jnet):
    def loss_fn(params, batch_stats, images, labels):
        outs, upd = jnet.apply({"params": params, "batch_stats": batch_stats},
                               images, train=True)
        layers = JLoss.yolo_loss_layers(labels, outs, JSPEC, images.shape[0],
                                        *LOSS_ARGS)
        main = layers[0] + layers[1]
        return main + JLoss.l2_penalty(params), (main, layers,
                                                 upd["batch_stats"])
    return loss_fn


def _port_losses(net, images, labels, dtype=torch.float32):
    outs = net(_t(images), dtype=dtype)
    layers = TLoss.yolo_loss_layers([_t(l) for l in labels], outs, TSPEC,
                                    images.shape[0], *LOSS_ARGS)
    return layers, layers[0] + layers[1]


def test_loss_and_every_gradient_match_jax_fp32():
    jnet, variables, flat = jax_net_and_flat()
    images, labels = _batch(2)
    (total, (main, layers, new_stats)), grads = jax.jit(jax.value_and_grad(
        _jax_loss_fn(jnet), has_aux=True))(
            variables["params"], variables["batch_stats"], jnp.asarray(images),
            [jnp.asarray(l) for l in labels])

    net = torch_net(flat).train()
    got_layers, got_main = _port_losses(net, images, labels)
    got_total = got_main + TLoss.l2_penalty(net)
    got_total.backward()
    np.testing.assert_allclose(float(got_total.detach()), float(total),
                               rtol=1e-5)
    for g, w in zip(got_layers, layers):
        np.testing.assert_allclose(float(g.detach()), float(w), rtol=1e-5)

    got_g = TC.flat_from_state_dict({n: p.grad for n, p in
                                     net.named_parameters()})
    want_g = _params_flat(grads)
    assert sorted(got_g) == sorted(want_g) and len(got_g) == 94
    for k in want_g:
        scale = np.abs(want_g[k]).max()
        assert scale > 0, k
        np.testing.assert_allclose(got_g[k], want_g[k], rtol=0,
                                   atol=1e-3 * scale, err_msg=k)
    # and the running statistics it moved
    got_stats = TC.flat_from_state_dict(net.state_dict())
    for k, v in _flatten(new_stats).items():
        np.testing.assert_allclose(got_stats[f"batch_stats/{k}"], v,
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_bf16_training_loss_matches_jax():
    jnet, variables, flat = jax_net_and_flat()
    jnet16 = jax_build("yolo_mobilev1", SMALL["in_hw"], SMALL["nanchors"],
                       SMALL["class_num"], alpha=SMALL["alpha"],
                       dtype=jnp.bfloat16)
    images, labels = _batch(3)
    _, (want, want_layers, _) = jax.jit(_jax_loss_fn(jnet16))(
        variables["params"], variables["batch_stats"],
        jnp.asarray(images).astype(jnp.bfloat16),
        [jnp.asarray(l) for l in labels])
    net = torch_net(flat).train()
    with torch.no_grad():
        outs = net(_t(images).to(torch.bfloat16), dtype=torch.bfloat16)
        assert all(o.dtype == torch.bfloat16 for o in outs)
        layers, main = _port_losses(net, images, labels, torch.bfloat16)
    np.testing.assert_allclose(float(main), float(want), rtol=2e-2)
    for g, w in zip(layers, want_layers):
        np.testing.assert_allclose(float(g), float(w), rtol=2e-2)


def test_adam_matches_optax_with_decay():
    kw = dict(init_learning_rate=1e-3, learning_rate_decay_factor=0.3)
    cfg = TConfig.TrainConfig(**kw)
    rng = np.random.default_rng(4)
    params = {"a": rng.normal(0, 1, (3, 4)).astype(np.float32),
              "b": rng.normal(0, 1, (5,)).astype(np.float32)}
    tx = JT.make_optimizer(JConfig.TrainConfig(**kw))
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    tparams = [torch.nn.Parameter(_t(params[k])) for k in ("a", "b")]
    opt = TT.make_optimizer(tparams, cfg)
    schedule = TT.keras_adam_schedule(cfg.init_learning_rate,
                                      cfg.learning_rate_decay_factor)
    for step in range(5):
        g = {k: (rng.normal(0, 10.0 ** -step, v.shape)).astype(np.float32)
             for k, v in params.items()}
        g["b"][0] = 0.0
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g),
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, k in zip(tparams, ("a", "b")):
            p.grad = _t(g[k])
        TT.adam_update(opt, schedule(step))
    for p, k in zip(tparams, ("a", "b")):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                   rtol=1e-6, atol=1e-7)
    assert schedule(4) == pytest.approx(1e-3 / 2.2)


def test_three_step_trajectory_matches_jax():
    """Augment off: three steps of the JAX package's jitted train step and
    the port's on the same three batches from the same weights."""
    jnet, variables, flat = jax_net_and_flat()
    tx = JT.make_optimizer(JCFG)
    params = jax.tree.map(jnp.copy, variables["params"])
    jstate = JT.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.copy, variables["batch_stats"]),
        opt_state=tx.init(params), masks=JP.init_masks(params),
        pr=JM.init_pr_state(2))
    jstep = JT.make_train_step(jnet, JSPEC, JCFG, train_epoch_step=10)
    state = TT.create_train_state(torch_net(flat), CFG, "cpu")
    step = TT.make_train_step(TSPEC, CFG)
    for seed, rtol in ((10, 1e-5), (11, 1e-3), (12, 1e-3)):
        images, labels = _batch(seed)
        jstate, jlogs = jstep(jstate, jnp.asarray(images),
                              tuple(jnp.asarray(l) for l in labels))
        state, logs = step(state, _t(images), [_t(l) for l in labels])
        assert sorted(logs) == sorted(jlogs)
        for k in ("loss", "l1_loss", "l2_loss", "lr"):
            np.testing.assert_allclose(float(logs[k]), float(jlogs[k]),
                                       rtol=rtol, err_msg=k)
    assert state.step == int(jstate.step) == 3


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return TPL.synthetic_ann_list(str(tmp_path_factory.mktemp("synth")), n=10,
                                  class_num=3)


def test_fit_two_steps_with_augment_on_cpu(synth):
    train, test = split_train_test(synth, 0.3)
    net = torch_net()
    before = {k: v.clone() for k, v in net.state_dict().items()}
    lines, scalars = [], []
    state = TT.fit(net, TSPEC, dataclasses.replace(CFG, max_epochs=1),
                   iter(TPL.DataPipeline(train, 4, seed=0, num_workers=2)),
                   iter(TPL.DataPipeline(test, 3, seed=0, num_workers=2)),
                   TPL.make_preprocess_fn(TSPEC, True),
                   TPL.make_preprocess_fn(TSPEC, False), 2, 1, device="cpu",
                   log_fn=lines.append,
                   scalar_logger=lambda s, d: scalars.append((s, d)))
    assert state.step == 2 and state.net is net and net.training
    assert [s for s, _ in scalars] == [1, 2]
    for _, d in scalars:
        assert {"loss", "p", "r", "lr", "l1_loss", "l2_r"} <= set(d)
        assert all(np.isfinite(v) for v in d.values())
    assert lines[0].startswith("epoch 1/1 step 1/2 loss ")
    assert "val_loss" in lines[-1]
    after = net.state_dict()
    for k in ("head.y1_out.dark_conv_out.weight",
              "backbone.stem.bn.running_mean", "backbone.stem.bn.running_var"):
        assert not torch.equal(after[k], before[k]), k


def test_fit_and_train_state_refuse_what_is_not_there():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU refusal cannot be shown")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.fit(torch_net(), TSPEC, CFG, iter(()), None, None, None, 1, 0,
               device="cuda")
    # pruning is there: all-ones masks over exactly the prunable
    # parameters (every conv kernel), the weights left as they were
    net = torch_net()
    before = {k: v.clone() for k, v in net.state_dict().items()}
    state = TT.create_train_state(net, dataclasses.replace(
        CFG, is_prune=True), "cpu")
    kernels = sorted(n for n, p in net.named_parameters() if p.ndim == 4)
    assert sorted(state.masks) == kernels and len(kernels) == 32
    for n, p in net.named_parameters():
        if n in state.masks:
            m = state.masks[n]
            assert m.shape == p.shape and bool((m == 1).all()), n
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert float(state.sparsity) == 0.0


def test_trained_state_round_trip_serves_like_jax():
    """Two port train steps on the CPU; the trained weights and running
    statistics cross the bridge into the JAX package's variables and back.
    The JAX Predictor and the port's serve them with the same detections
    (tolerances of tests/test_torch_predictor.py)."""
    _, variables, flat = jax_net_and_flat()
    state = TT.create_train_state(torch_net(flat), CFG, "cpu")
    step = TT.make_train_step(TSPEC, CFG)
    images, labels = _batch(20)
    for _ in range(2):
        state, _ = step(state, _t(images), [_t(l) for l in labels])
    trained = TC.flat_from_state_dict(state.net.state_dict())
    assert sorted(trained) == sorted(flat)
    assert not np.array_equal(trained["batch_stats/backbone/stem/bn/mean"],
                              flat["batch_stats/backbone/stem/bn/mean"])
    back = TC.state_dict_from_flat(trained, torch_net())
    for k, v in state.net.state_dict().items():
        assert torch.equal(back[k], v), k

    jnet, _, _ = jax_net_and_flat()
    jp = JaxPredictor(jnet, _unflatten(trained), JSPEC, **THRESH)
    tp = Predictor(torch_net(), back, TSPEC, device="cpu", **THRESH)
    canvases, hws, img = _scene()
    got = tp.predict_batch(canvases, hws)
    assert sum(len(d.scores) for d in got) > 0
    assert_detections_close(stack_detections(got),
                            stack_detections(jp.predict_batch(canvases, hws)))

"""The train and eval steps and the epoch loop.

Counterpart of ``k210_yolo_framework_tpu/training/train.py``
(``keras_adam_schedule``, ``make_optimizer``, ``TrainState``,
``create_train_state``, the train / eval steps, their fused
"preprocess then step" forms, ``fit`` and ``recalibrate_batch_stats``).
One train step: forward with BatchNorm on batch statistics, the five-term
loss per output layer, the l2 penalty, backward, Adam at
``lr / (1 + decay * step)``, and the streaming P/R counters.

Where JAX returns a new state, the port updates in place: the net holds the
parameters and the BN running statistics, the optimizer its moments, and
:class:`TrainState` also the step count and the P/R counters; each step
returns the same state object.  Logged scalars stay on the device until the
10-step print boundary, which fetches them in one copy.  With
``cfg.is_prune`` the state also holds magnitude masks over the conv kernels
(``training/pruning.py``): after each Adam update the masks are recomputed
when the schedule is due and multiplied into the weights.

On a pure data-parallel mesh (``parallel.make_mesh``, one process a
device) the steps and ``fit`` take ``mesh=`` and compute what JAX's one
GSPMD program over the sharded batch computes: each rank holds the batch
slots of ``parallel.slot_range``; BatchNorm normalises with the global
batch's statistics (``models.layers.set_data_group``); each rank's loss
keeps its own B / dp as normaliser, and the gradients (with the l2
penalty's, added once a rank) are summed over the data axis and divided by
dp, which is the gradient of the global loss; the logged losses are the
mean over ranks and the P/R counters the sum.  The parameters, BN
statistics, Adam moments, masks and step count start as rank 0's
(:func:`shard_state`) and stay identical on every rank.

On a mesh with a model or space axis (any builder) each rank of a data
coordinate holds the same slots and computes its part of the forward:
its output channels of each kernel ``param_shardings`` marks and its
rows of each activation whose rows divide (``parallel/sharded.py``);
BatchNorm sums its moments over data x space while a layer's rows are
split, over data after.  TP here shards the compute, not the storage:
every rank keeps every parameter whole and computes with its slice, so
Adam, pruning's per-kernel threshold and the checkpoints are as on one
device, and the state is laid out as JAX's is after the same steps.  The
gradient rule is one rule with one collective: each rank's loss
(replicated over its model and space peers) is scaled by 1 / (mp * sp)
before ``backward()``, the collectives' backwards sum what each rank's
slice fed, and every ``.grad`` is then summed over the world and divided
by dp.  At mp = sp = 1 that is the data-parallel mean above, exactly.
The logged losses and the P/R counters reduce over the data axis only.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional

import torch
import torch.distributed as dist

from k210_yolo_framework_tpu_torch.config import TrainConfig, YoloSpec
from k210_yolo_framework_tpu_torch.models.layers import (
    BatchNorm,
    set_data_group,
)
from k210_yolo_framework_tpu_torch.models.yolonet import YoloNet
from k210_yolo_framework_tpu_torch.parallel import mesh as PM
from k210_yolo_framework_tpu_torch.parallel.sharded import ShardContext
from k210_yolo_framework_tpu_torch.training import loss as L
from k210_yolo_framework_tpu_torch.training import metrics as M
from k210_yolo_framework_tpu_torch.training import pruning as P
from k210_yolo_framework_tpu_torch.utils.trace import span

__all__ = ["keras_adam_schedule", "make_optimizer", "adam_update",
           "TrainState", "create_train_state", "make_train_step",
           "make_eval_step",
           "make_fused_train_step", "make_fused_eval_step", "fit",
           "recalibrate_batch_stats", "checked_device", "prune_step",
           "shard_state"]


def keras_adam_schedule(init_lr: float, decay: float) -> Callable:
    """keras ``Adam(lr, decay)``: lr_t = lr / (1 + decay * t), t counting
    from 0 at the first step."""
    def schedule(count):
        return init_lr / (1.0 + decay * count)
    return schedule


def make_optimizer(params, cfg: TrainConfig) -> torch.optim.Adam:
    """``optax.adam``'s constants (b1 0.9, b2 0.999, eps 1e-8, no eps_root,
    no weight decay).  The train step sets the learning rate before each
    update from :func:`keras_adam_schedule`."""
    return torch.optim.Adam(params, lr=cfg.init_learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


def adam_update(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """One optimizer step at learning rate ``lr`` on the gradients in
    ``.grad``."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()


@dataclasses.dataclass
class TrainState:
    """``masks`` (parameter name -> 0/1 tensor) exist only for the prunable
    parameters and only when pruning; ``sparsity`` is their share of zeros,
    a device scalar recomputed with them."""
    net: YoloNet
    optimizer: torch.optim.Optimizer
    step: int
    pr: Dict[str, torch.Tensor]
    masks: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    sparsity: Optional[torch.Tensor] = None


def checked_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device with no card
    raises (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: no CUDA device is "
                           "available")
    return device


def create_train_state(net: YoloNet, cfg: TrainConfig, device) -> TrainState:
    """Move ``net`` to ``device`` (channels_last, as served) in train mode
    and give it an optimizer; the net is trained in place.  With
    ``cfg.is_prune`` the masks start at all ones and are applied at once,
    as JAX's ``init_masks`` are (the weights stay as they are)."""
    device = checked_device(device)
    net.to(device, memory_format=torch.channels_last).train()
    state = TrainState(net=net,
                       optimizer=make_optimizer(net.parameters(), cfg),
                       step=0, pr=M.init_pr_state(net.n_out_layers, device))
    if cfg.is_prune:
        state.masks = P.init_masks(net)
        P.apply_masks(dict(net.named_parameters()), state.masks)
        state.sparsity = P.sparsity_of(state.masks)
    return state


def prune_step(state: TrainState, cfg: TrainConfig, prune_end: int) -> None:
    """After an update at ``state.step``: recompute the masks where the
    schedule is due (every ``prune_frequency`` steps up to ``prune_end``),
    then multiply them into the weights.  The step count is the host's, so
    deciding costs no device sync."""
    params = dict(state.net.named_parameters())
    if state.step % cfg.prune_frequency == 0 and state.step <= prune_end:
        sparsity = P.polynomial_sparsity(
            state.step, cfg.prune_initial_sparsity, cfg.prune_final_sparsity,
            0, prune_end)
        state.masks = P.update_masks(params, state.masks, sparsity)
        state.sparsity = P.sparsity_of(state.masks)
    P.apply_masks(params, state.masks)


def shard_state(state: TrainState, mesh) -> TrainState:
    """Replicate rank 0's state over every rank of the mesh, in place: world
    rank 0 broadcasts the parameters (whole: a model rank computes with its
    slice of a kernel but stores all of it), BN statistics, Adam moments
    and step counts, pruning masks, P/R counters and the step count.
    Returns ``state``."""
    group = PM.world_group(mesh)
    src = dist.get_global_rank(group, 0)
    net, opt = state.net, state.optimizer
    params = [p for g in opt.param_groups for p in g["params"]]
    # the step count, and each parameter's Adam step (-1: no moments yet)
    meta = torch.tensor(
        [state.step] + [float(opt.state[p]["step"]) if p in opt.state
                        else -1.0 for p in params],
        dtype=torch.float64, device=params[0].device)
    dist.broadcast(meta, src=src, group=group)
    meta = meta.tolist()
    state.step = int(meta[0])
    moments = []
    for p, adam_step in zip(params, meta[1:]):
        if adam_step < 0:
            opt.state.pop(p, None)
            continue
        held = opt.state[p]
        for k in ("exp_avg", "exp_avg_sq"):
            if k not in held:
                held[k] = torch.zeros_like(p,
                                           memory_format=torch.preserve_format)
            moments.append(held[k])
        held["step"] = torch.tensor(adam_step, dtype=torch.float32)
    tensors = (list(net.parameters()) + list(net.buffers()) + moments
               + list(state.masks.values()) + list(state.pr.values()))
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=src, group=group)
    if state.masks:
        state.sparsity = P.sparsity_of(state.masks)
    return state


def _mean_grads(params, group, dp: int) -> None:
    """Each parameter's ``.grad`` replaced by its sum over ``group`` (the
    world) divided by ``dp``, in one collective."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = PM.sum_over_data(torch.cat([g.reshape(-1) for g in grads]),
                            group).div_(dp)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view(g.shape))


@dataclasses.dataclass
class _Axes:
    """What a step needs of its mesh: the data group (the losses and P/R
    counters), the world group and dp (the gradients), the TP/SP forward's
    context (None at mp = sp = 1) and the loss scale 1 / (mp * sp)."""
    data: object
    world: object
    dp: int
    shard: Optional[ShardContext]
    loss_scale: float


def _axes(mesh) -> Optional[_Axes]:
    """The step's view of ``mesh``, or None without one."""
    if mesh is None:
        return None
    model_space = PM.axis_size(mesh, PM.MODEL_AXIS) * PM.axis_size(
        mesh, PM.SPACE_AXIS)
    return _Axes(data=PM.data_group(mesh), world=PM.world_group(mesh),
                 dp=PM.axis_size(mesh, PM.DATA_AXIS),
                 shard=ShardContext(mesh) if model_space > 1 else None,
                 loss_scale=1.0 / model_space)


def _layer_logs(logs: dict, prefix: str, layer_losses, pr) -> dict:
    p_l, r_l = M.pr_results_per_layer(pr)
    for l, ll in enumerate(layer_losses):
        logs[f"{prefix}l{l + 1}_loss"] = ll.detach()
        logs[f"{prefix}l{l + 1}_p"] = p_l[l]
        logs[f"{prefix}l{l + 1}_r"] = r_l[l]
    return logs


def _forward(net, images, dtype, axes=None):
    """The net's outputs; on a mesh (``axes``) BatchNorm takes the global
    batch's statistics, and with a model or space axis the forward is this
    rank's part, its outputs whole."""
    if axes is not None and axes.shard is not None:
        return net(images, dtype=dtype, shard=axes.shard)
    set_data_group(net, None if axes is None else axes.data)
    try:
        return net(images, dtype=dtype)
    finally:
        set_data_group(net, None)


def _losses(spec, cfg, outs, labels, batch: int):
    """(per-layer losses, their sum); the normaliser ``batch`` is this
    batch's (a rank's shard's) size."""
    layer_losses = L.yolo_loss_layers(
        labels, outs, spec, batch, cfg.obj_thresh, cfg.iou_thresh,
        cfg.obj_weight, cfg.noobj_weight, cfg.wh_weight)
    return layer_losses, sum(layer_losses[1:], layer_losses[0])


def _mean_losses(main, layer_losses, group):
    """The logged losses: the mean over ``group`` of each rank's (main,
    per-layer), in one collective; unchanged without a group."""
    if group is None:
        return main.detach(), [ll.detach() for ll in layer_losses]
    both = PM.mean_over_data(
        torch.stack([main.detach()] + [ll.detach() for ll in layer_losses]),
        group)
    return both[0], list(both[1:])


def make_train_step(spec: YoloSpec, cfg: TrainConfig,
                    compute_dtype: torch.dtype = torch.float32,
                    train_epoch_step: Optional[int] = None, mesh=None):
    """(state, images [B, H, W, 3], labels per layer) -> (state, logs),
    in a ``train.step`` span (``utils.trace``).
    ``compute_dtype`` is the convs' dtype (the JAX net's ``dtype``); the
    parameters stay fp32.  After the step every parameter's ``.grad`` holds
    the gradient of ``loss + l2`` that the update used.  With
    ``cfg.is_prune``, ``train_epoch_step`` (steps an epoch) is required:
    the schedule ends after ``prune_end_epoch`` epochs; the masks follow
    the update (:func:`prune_step`) and ``logs["sparsity"]`` is their share
    of zeros.  With ``mesh`` each rank is given its data coordinate's
    slots of the global batch and the step is the global batch's (module
    docstring); the state must be replicated (:func:`shard_state`)."""
    body = _train_body(spec, cfg, compute_dtype, train_epoch_step, mesh)

    def step(state: TrainState, images: torch.Tensor, labels):
        with span("train.step"):
            return body(state, images, labels)

    return step


def _train_body(spec: YoloSpec, cfg: TrainConfig,
                compute_dtype: torch.dtype, train_epoch_step: Optional[int],
                mesh):
    """:func:`make_train_step`'s step outside its ``train.step`` span, its
    stages in spans of their own: ``train.forward``, ``train.loss``,
    ``train.backward``, ``train.grad_allreduce`` (on a mesh),
    ``train.optimizer``, ``train.metrics``."""
    axes = _axes(mesh)
    group = None if axes is None else axes.data
    if cfg.is_prune and train_epoch_step is None:
        raise ValueError("pruning needs train_epoch_step: the schedule ends "
                         "after prune_end_epoch epochs")
    # the step at which the schedule reaches its final sparsity
    prune_end = max((train_epoch_step or 1) * cfg.prune_end_epoch, 1)
    schedule = keras_adam_schedule(cfg.init_learning_rate,
                                   cfg.learning_rate_decay_factor)

    def body(state: TrainState, images: torch.Tensor, labels):
        net, opt = state.net, state.optimizer
        net.train()
        with span("train.forward"):
            outs = _forward(net, images, compute_dtype, axes)
        with span("train.loss"):
            layer_losses, main = _losses(spec, cfg, outs, labels,
                                         images.shape[0])
            total = main + L.l2_penalty(net)
            if axes is not None and axes.loss_scale != 1.0:
                # replicated over the model and space peers: each backs
                # 1/(mp sp)
                total = total * axes.loss_scale
        with span("train.backward"):
            # the grads are set to None (no device work): the l2 penalty
            # above reads none of them
            opt.zero_grad(set_to_none=True)
            total.backward()
        if axes is not None:
            with span("train.grad_allreduce"):
                # each rank's sum already holds every rank's share through
                # the collectives' backwards: the world's sum over dp is
                # the global gradient
                _mean_grads(net.parameters(), axes.world, axes.dp)
        with span("train.optimizer"):
            lr = schedule(state.step)
            adam_update(opt, lr)
            if cfg.is_prune:
                prune_step(state, cfg, prune_end)

        with span("train.metrics"):
            state.pr = M.update_pr_state(state.pr, labels,
                                         [o.detach() for o in outs],
                                         cfg.obj_thresh, group=group)
            p, r = M.pr_results(state.pr)
            main, layer_losses = _mean_losses(main, layer_losses, group)
            logs = {"loss": main, "p": p, "r": r, "lr": lr}
            _layer_logs(logs, "", layer_losses, state.pr)
            if cfg.is_prune:
                logs["sparsity"] = state.sparsity
        state.step += 1
        return state, logs

    return body


def make_eval_step(spec: YoloSpec, cfg: TrainConfig,
                   compute_dtype: torch.dtype = torch.float32, mesh=None):
    """(net, pr, images, labels) -> (pr, logs) with BatchNorm on its
    running statistics; the net's train/eval mode is restored after.  With
    ``mesh`` each rank is given its slots of the test batch; ``val_loss``
    is the mean over ranks and the counters the sum."""
    axes = _axes(mesh)
    group = None if axes is None else axes.data
    # eval-mode BatchNorm reduces nothing: only a TP/SP forward needs the
    # mesh
    fwd_axes = axes if axes is not None and axes.shard is not None else None

    @torch.no_grad()
    def step(net: YoloNet, pr, images, labels):
        was_training = net.training
        net.eval()
        try:
            outs = _forward(net, images, compute_dtype, fwd_axes)
            layer_losses, loss = _losses(spec, cfg, outs, labels,
                                         images.shape[0])
        finally:
            net.train(was_training)
        pr = M.update_pr_state(pr, labels, outs, cfg.obj_thresh,
                               group=group)
        loss, layer_losses = _mean_losses(loss, layer_losses, group)
        p, r = M.pr_results(pr)
        logs = {"val_loss": loss, "val_p": p, "val_r": r}
        return pr, _layer_logs(logs, "val_", layer_losses, pr)

    return step


def _device_of(net) -> torch.device:
    return next(net.parameters()).device


def make_fused_train_step(spec: YoloSpec, cfg: TrainConfig, preprocess,
                          compute_dtype: torch.dtype = torch.float32,
                          train_epoch_step: Optional[int] = None,
                          mesh=None):
    """Preprocess (letterbox, augment, /max, encode; no gradients) then
    the train step:

    (state, canvases u8, img_hws, boxes, valid, generator=None,
     params=None) -> (state, logs).

    With ``mesh`` every rank is given the whole global batch on the host
    (a ``HostBatch``, as JAX's one controller is) and the global batch's
    draws (``generator`` in step on every rank, or ``params``); it
    preprocesses its slots (``make_preprocess_fn``'s ``slots``), copying
    only their source images to its device, then takes the sharded
    step.  One ``train.step`` span holds the preprocess
    (``train.preprocess``) and the step's stages."""
    body = _train_body(spec, cfg, compute_dtype, train_epoch_step, mesh)

    def fused(state, canvases, img_hws, boxes, valid, generator=None,
              params=None):
        with span("train.step"):
            shard = {} if mesh is None else dict(
                slots=PM.slot_range(len(img_hws), mesh),
                device=_device_of(state.net))
            with torch.no_grad(), span("train.preprocess"):
                images, labels = preprocess(canvases, img_hws, boxes, valid,
                                            generator, params, **shard)
            return body(state, images, labels)

    return fused


def make_fused_eval_step(spec: YoloSpec, cfg: TrainConfig, preprocess,
                         compute_dtype: torch.dtype = torch.float32,
                         mesh=None):
    """Eval preprocess then the eval step:
    (net, pr, canvases, img_hws, boxes, valid) -> (pr, logs).  With
    ``mesh`` every rank is given the whole test batch on the host and takes
    its contiguous slots."""
    step = make_eval_step(spec, cfg, compute_dtype, mesh)

    def fused(net, pr, canvases, img_hws, boxes, valid):
        shard = {} if mesh is None else dict(
            slots=PM.slot_range(len(img_hws), mesh), device=_device_of(net))
        with torch.no_grad():
            images, labels = preprocess(canvases, img_hws, boxes, valid,
                                        **shard)
        return step(net, pr, images, labels)

    return fused


def _flush_scalars(scalar_logger, pending_logs) -> None:
    """Hand buffered (step, logs) to ``scalar_logger``, fetching every
    device scalar in one copy."""
    if scalar_logger is not None and pending_logs:
        tensors = [v.to(torch.float32) for _, lg in pending_logs
                   for v in lg.values() if torch.is_tensor(v)]
        fetched = iter(torch.stack(tensors).cpu().tolist() if tensors else ())
        for s, lg in pending_logs:
            scalar_logger(s, {k: next(fetched) if torch.is_tensor(v)
                              else float(v) for k, v in lg.items()})
    pending_logs.clear()


def _start_profiler(device: torch.device, log_fn):
    """A started ``torch.profiler.profile``, or None (logged) where the
    profiler cannot start."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    # tracing is optional: the step runs whatever the profiler raises
    except Exception as e:  # noqa: BLE001
        log_fn(f"profiler unavailable: {e}")
        return None
    return prof


def _write_trace(prof, device: torch.device, profile_dir: str, step: int,
                 log_fn) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"trace_step{step}.json"
    prof.export_chrome_trace(str(path))
    log_fn(f"profiler trace written to {path}")


def fit(net: YoloNet, spec: YoloSpec, cfg: TrainConfig,
        train_batches: Iterator, test_batches: Optional[Iterator],
        preprocess_train, preprocess_test,
        train_epoch_step: int, test_epoch_step: int, *,
        device, generator: Optional[torch.Generator] = None,
        compute_dtype: torch.dtype = torch.float32,
        log_fn: Callable[[str], None] = print,
        scalar_logger=None,
        state: Optional[TrainState] = None,
        profile_dir: str = "", profile_step: int = 3,
        mesh=None) -> TrainState:
    """The epoch loop: a loss/p/r line every 10 steps, one validation pass
    per epoch, and SIGINT / SIGTERM stop at a step boundary with the state
    whole.  ``train_batches`` / ``test_batches`` yield ``HostBatch``es;
    the augment draws come from ``generator`` (a CPU generator seeded with
    ``cfg.rand_seed`` when none is given).  With ``profile_dir``, the step
    that makes the run's step count ``profile_step`` runs under
    ``torch.profiler`` (CUDA activity too on a CUDA device) and its Chrome
    trace is written there; a profiler that cannot start is logged and the
    step runs unprofiled.  Returns the final state.

    With ``mesh`` (pure data parallelism, one process a device, ``device``
    this rank's) every rank runs this loop over the same batches and the
    same generator: the state is replicated from rank 0
    (:func:`shard_state`), each step is the sharded one, and the log lines,
    ``scalar_logger`` and the profiler run on world rank 0 only.  A stop
    signal on any rank stops every rank after the same step (the flag is
    agreed over a gloo group of the whole world each step, a host
    collective)."""
    device = checked_device(device)
    group = None if mesh is None else PM.data_group(mesh)
    if group is not None and dist.get_rank() != 0:
        log_fn, scalar_logger, profile_dir = (lambda _line: None), None, ""
    if state is None:
        state = create_train_state(net, cfg, device)
    if group is not None:
        shard_state(state, mesh)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.rand_seed)
    train_step = make_fused_train_step(spec, cfg, preprocess_train,
                                       compute_dtype, train_epoch_step, mesh)
    eval_step = make_fused_eval_step(spec, cfg, preprocess_test,
                                     compute_dtype, mesh)
    n_layers = state.net.n_out_layers
    pending_logs = []
    stop_requested = {"flag": False}
    stop_group, made = PM.host_group(mesh) if group is not None \
        else (None, False)

    def stopping() -> bool:
        """The stop flag, raised on any rank (MAX over the gloo group)."""
        if stop_group is None:
            return stop_requested["flag"]
        flag = torch.tensor([int(stop_requested["flag"])])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=stop_group)
        return bool(flag.item())

    def on_device(hb):
        # on a mesh the step copies only its slots' sources
        return hb if group is not None else hb.to(device)

    def _request_stop(_sig, _frm):
        stop_requested["flag"] = True

    # handlers only set a flag, read at step boundaries; installed right
    # before the try/finally that restores them
    prev_handlers = []
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers.append((sig, signal.signal(sig, _request_stop)))
        except ValueError:  # not the main thread
            pass
    try:
        for epoch in range(cfg.max_epochs):
            state.pr = M.init_pr_state(n_layers, device)
            t0 = time.time()
            logs = {}
            for i in range(train_epoch_step):
                prof = None
                if profile_dir and state.step + 1 == profile_step:
                    prof = _start_profiler(device, log_fn)
                try:
                    with span("fit.load"):
                        hb = on_device(next(train_batches))
                    state, logs = train_step(state, *hb, generator)
                finally:
                    if prof is not None:
                        _write_trace(prof, device, profile_dir, state.step,
                                     log_fn)
                pending_logs.append((state.step, logs))
                if i % 10 == 0 or i == train_epoch_step - 1:
                    _flush_scalars(scalar_logger, pending_logs)
                    per_layer = " ".join(
                        f"l{l + 1}_loss {float(logs[f'l{l + 1}_loss']):.4f} "
                        f"l{l + 1}_p {float(logs[f'l{l + 1}_p']):.3f} "
                        f"l{l + 1}_r {float(logs[f'l{l + 1}_r']):.3f}"
                        for l in range(n_layers))
                    log_fn(f"epoch {epoch + 1}/{cfg.max_epochs} step "
                           f"{i + 1}/{train_epoch_step} loss "
                           f"{float(logs['loss']):.4f} p "
                           f"{float(logs['p']):.4f} r {float(logs['r']):.4f} "
                           f"{per_layer}")
                if stopping():
                    raise KeyboardInterrupt
            dt = time.time() - t0
            rate = train_epoch_step * cfg.batch_size / max(dt, 1e-9)

            if test_batches is not None and test_epoch_step > 0:
                pr = M.init_pr_state(n_layers, device)
                vloss_sum, vlogs = 0.0, {}
                for _ in range(test_epoch_step):
                    hb = on_device(next(test_batches))
                    pr, vlogs = eval_step(state.net, pr, *hb)
                    vloss_sum += float(vlogs["val_loss"])
                log_fn(f"epoch {epoch + 1} done in {dt:.1f}s ({rate:.0f} "
                       f"img/s)  val_loss {vloss_sum / test_epoch_step:.4f} "
                       f"val_p {float(vlogs['val_p']):.4f} "
                       f"val_r {float(vlogs['val_r']):.4f}")
            else:
                log_fn(f"epoch {epoch + 1} done in {dt:.1f}s ({rate:.0f} "
                       f"img/s) loss {float(logs['loss']):.4f}")
            if stopping():
                raise KeyboardInterrupt
    except KeyboardInterrupt:
        log_fn("interrupted: returning the state of the last whole step")
    finally:
        _flush_scalars(scalar_logger, pending_logs)
        for sig, prev in prev_handlers:
            signal.signal(sig, prev)
        if made:
            dist.destroy_process_group(stop_group)
    return state


@torch.no_grad()
def recalibrate_batch_stats(net: YoloNet, batches: Iterator, preprocess,
                            num_batches: int = 50, *, device,
                            generator: Optional[torch.Generator] = None,
                            compute_dtype: torch.dtype = torch.float32,
                            mesh=None) -> YoloNet:
    """Replace every BatchNorm's EMA statistics with the arithmetic mean of
    its exact per-batch moments over ``num_batches`` preprocessed batches
    (the SWA ``update_bn`` recipe), in place; the net's train/eval mode and
    each BatchNorm's momentum are restored after.

    The JAX package recovers each layer's momentum m with a zeros / ones
    probe and divides ``(1 - m) * batch`` by ``1 - m``; here every
    ``BatchNorm.momentum`` is set to 0 for the forwards, so each leaves its
    batch moments in the running statistics exactly, whatever its own m.
    ``batches`` yield ``HostBatch``es; ``preprocess`` is
    ``make_preprocess_fn``'s, drawing its augment from ``generator``.  With
    ``mesh`` every rank is given the same batches, preprocesses its data
    coordinate's slots, and each batch's moments are the global batch's
    (summed over the data axis).  A model or space axis changes nothing:
    the JAX package recalibrates on one device after training on any
    mesh, so each rank runs the whole, unsharded net on its slots (the
    weights are whole on every rank), and its model and space peers
    compute the same statistics."""
    device = checked_device(device)
    group = None if mesh is None else PM.data_group(mesh)
    bns = [m for m in net.modules() if isinstance(m, BatchNorm)]
    ema = {bn: (bn.running_mean.clone(), bn.running_var.clone(), bn.momentum)
           for bn in bns}
    sums = {bn: (torch.zeros_like(bn.running_mean),
                 torch.zeros_like(bn.running_var)) for bn in bns}
    was_training = net.training
    net.train()
    try:
        for bn in bns:
            bn.momentum = 0.0
        set_data_group(net, group)
        for _ in range(num_batches):
            hb = next(batches)
            if group is None:
                images, _ = preprocess(*hb.to(device), generator)
            else:
                images, _ = preprocess(
                    *hb, generator,
                    slots=PM.slot_range(len(hb.img_hws), mesh),
                    device=device)
            net(images, dtype=compute_dtype)
            for bn in bns:
                sums[bn][0].add_(bn.running_mean)
                sums[bn][1].add_(bn.running_var)
    except BaseException:
        # a failed batch leaves the statistics as they came
        for bn, (mean, var, _) in ema.items():
            bn.running_mean.copy_(mean)
            bn.running_var.copy_(var)
        raise
    finally:
        for bn, (_, _, momentum) in ema.items():
            bn.momentum = momentum
        set_data_group(net, None)
        net.train(was_training)
    for bn, (mean, var) in sums.items():
        bn.running_mean.copy_(mean / num_batches)
        bn.running_var.copy_(var / num_batches)
    return net

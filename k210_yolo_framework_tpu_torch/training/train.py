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
"""

from __future__ import annotations

import dataclasses
import signal
import time
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional

import torch

from k210_yolo_framework_tpu_torch.config import TrainConfig, YoloSpec
from k210_yolo_framework_tpu_torch.models.layers import BatchNorm
from k210_yolo_framework_tpu_torch.models.yolonet import YoloNet
from k210_yolo_framework_tpu_torch.training import loss as L
from k210_yolo_framework_tpu_torch.training import metrics as M
from k210_yolo_framework_tpu_torch.training import pruning as P

__all__ = ["keras_adam_schedule", "make_optimizer", "adam_update",
           "TrainState", "create_train_state", "make_train_step",
           "make_eval_step",
           "make_fused_train_step", "make_fused_eval_step", "fit",
           "recalibrate_batch_stats", "checked_device", "prune_step"]


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


def _layer_logs(logs: dict, prefix: str, layer_losses, pr) -> dict:
    p_l, r_l = M.pr_results_per_layer(pr)
    for l, ll in enumerate(layer_losses):
        logs[f"{prefix}l{l + 1}_loss"] = ll.detach()
        logs[f"{prefix}l{l + 1}_p"] = p_l[l]
        logs[f"{prefix}l{l + 1}_r"] = r_l[l]
    return logs


def _losses(net, spec, cfg, images, labels, dtype):
    outs = net(images, dtype=dtype)
    layer_losses = L.yolo_loss_layers(
        labels, outs, spec, images.shape[0], cfg.obj_thresh, cfg.iou_thresh,
        cfg.obj_weight, cfg.noobj_weight, cfg.wh_weight)
    return outs, layer_losses, sum(layer_losses[1:], layer_losses[0])


def make_train_step(spec: YoloSpec, cfg: TrainConfig,
                    compute_dtype: torch.dtype = torch.float32,
                    train_epoch_step: Optional[int] = None):
    """(state, images [B, H, W, 3], labels per layer) -> (state, logs).
    ``compute_dtype`` is the convs' dtype (the JAX net's ``dtype``); the
    parameters stay fp32.  After the step every parameter's ``.grad`` holds
    the gradient of ``loss + l2`` that the update used.  With
    ``cfg.is_prune``, ``train_epoch_step`` (steps an epoch) is required:
    the schedule ends after ``prune_end_epoch`` epochs; the masks follow
    the update (:func:`prune_step`) and ``logs["sparsity"]`` is their share
    of zeros."""
    if cfg.is_prune and train_epoch_step is None:
        raise ValueError("pruning needs train_epoch_step: the schedule ends "
                         "after prune_end_epoch epochs")
    # the step at which the schedule reaches its final sparsity
    prune_end = max((train_epoch_step or 1) * cfg.prune_end_epoch, 1)
    schedule = keras_adam_schedule(cfg.init_learning_rate,
                                   cfg.learning_rate_decay_factor)

    def step(state: TrainState, images: torch.Tensor, labels):
        net, opt = state.net, state.optimizer
        net.train()
        outs, layer_losses, main = _losses(net, spec, cfg, images, labels,
                                           compute_dtype)
        opt.zero_grad(set_to_none=True)
        (main + L.l2_penalty(net)).backward()
        lr = schedule(state.step)
        adam_update(opt, lr)
        if cfg.is_prune:
            prune_step(state, cfg, prune_end)

        state.pr = M.update_pr_state(state.pr, labels,
                                     [o.detach() for o in outs],
                                     cfg.obj_thresh)
        p, r = M.pr_results(state.pr)
        logs = {"loss": main.detach(), "p": p, "r": r, "lr": lr}
        _layer_logs(logs, "", layer_losses, state.pr)
        if cfg.is_prune:
            logs["sparsity"] = state.sparsity
        state.step += 1
        return state, logs

    return step


def make_eval_step(spec: YoloSpec, cfg: TrainConfig,
                   compute_dtype: torch.dtype = torch.float32):
    """(net, pr, images, labels) -> (pr, logs) with BatchNorm on its
    running statistics; the net's train/eval mode is restored after."""

    @torch.no_grad()
    def step(net: YoloNet, pr, images, labels):
        was_training = net.training
        net.eval()
        try:
            outs, layer_losses, loss = _losses(net, spec, cfg, images,
                                               labels, compute_dtype)
        finally:
            net.train(was_training)
        pr = M.update_pr_state(pr, labels, outs, cfg.obj_thresh)
        p, r = M.pr_results(pr)
        logs = {"val_loss": loss, "val_p": p, "val_r": r}
        return pr, _layer_logs(logs, "val_", layer_losses, pr)

    return step


def make_fused_train_step(spec: YoloSpec, cfg: TrainConfig, preprocess,
                          compute_dtype: torch.dtype = torch.float32,
                          train_epoch_step: Optional[int] = None):
    """Preprocess (letterbox, augment, /max, encode; no gradients) then
    the train step:

    (state, canvases u8, img_hws, boxes, valid, generator=None,
     params=None) -> (state, logs)."""
    step = make_train_step(spec, cfg, compute_dtype, train_epoch_step)

    def fused(state, canvases, img_hws, boxes, valid, generator=None,
              params=None):
        with torch.no_grad():
            images, labels = preprocess(canvases, img_hws, boxes, valid,
                                        generator, params)
        return step(state, images, labels)

    return fused


def make_fused_eval_step(spec: YoloSpec, cfg: TrainConfig, preprocess,
                         compute_dtype: torch.dtype = torch.float32):
    """Eval preprocess then the eval step:
    (net, pr, canvases, img_hws, boxes, valid) -> (pr, logs)."""
    step = make_eval_step(spec, cfg, compute_dtype)

    def fused(net, pr, canvases, img_hws, boxes, valid):
        with torch.no_grad():
            images, labels = preprocess(canvases, img_hws, boxes, valid)
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
        profile_dir: str = "", profile_step: int = 3) -> TrainState:
    """The epoch loop: a loss/p/r line every 10 steps, one validation pass
    per epoch, and SIGINT / SIGTERM stop at a step boundary with the state
    whole.  ``train_batches`` / ``test_batches`` yield ``HostBatch``es;
    the augment draws come from ``generator`` (a CPU generator seeded with
    ``cfg.rand_seed`` when none is given).  With ``profile_dir``, the step
    that makes the run's step count ``profile_step`` runs under
    ``torch.profiler`` (CUDA activity too on a CUDA device) and its Chrome
    trace is written there; a profiler that cannot start is logged and the
    step runs unprofiled.  Returns the final state."""
    device = checked_device(device)
    if state is None:
        state = create_train_state(net, cfg, device)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.rand_seed)
    train_step = make_fused_train_step(spec, cfg, preprocess_train,
                                       compute_dtype, train_epoch_step)
    eval_step = make_fused_eval_step(spec, cfg, preprocess_test,
                                     compute_dtype)
    n_layers = state.net.n_out_layers
    pending_logs = []
    stop_requested = {"flag": False}

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
                    hb = next(train_batches).to(device)
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
                if stop_requested["flag"]:
                    raise KeyboardInterrupt
            dt = time.time() - t0
            rate = train_epoch_step * cfg.batch_size / max(dt, 1e-9)

            if test_batches is not None and test_epoch_step > 0:
                pr = M.init_pr_state(n_layers, device)
                vloss_sum, vlogs = 0.0, {}
                for _ in range(test_epoch_step):
                    hb = next(test_batches).to(device)
                    pr, vlogs = eval_step(state.net, pr, *hb)
                    vloss_sum += float(vlogs["val_loss"])
                log_fn(f"epoch {epoch + 1} done in {dt:.1f}s ({rate:.0f} "
                       f"img/s)  val_loss {vloss_sum / test_epoch_step:.4f} "
                       f"val_p {float(vlogs['val_p']):.4f} "
                       f"val_r {float(vlogs['val_r']):.4f}")
            else:
                log_fn(f"epoch {epoch + 1} done in {dt:.1f}s ({rate:.0f} "
                       f"img/s) loss {float(logs['loss']):.4f}")
            if stop_requested["flag"]:
                raise KeyboardInterrupt
    except KeyboardInterrupt:
        log_fn("interrupted: returning the state of the last whole step")
    finally:
        _flush_scalars(scalar_logger, pending_logs)
        for sig, prev in prev_handlers:
            signal.signal(sig, prev)
    return state


@torch.no_grad()
def recalibrate_batch_stats(net: YoloNet, batches: Iterator, preprocess,
                            num_batches: int = 50, *, device,
                            generator: Optional[torch.Generator] = None,
                            compute_dtype: torch.dtype = torch.float32
                            ) -> YoloNet:
    """Replace every BatchNorm's EMA statistics with the arithmetic mean of
    its exact per-batch moments over ``num_batches`` preprocessed batches
    (the SWA ``update_bn`` recipe), in place; the net's train/eval mode and
    each BatchNorm's momentum are restored after.

    The JAX package recovers each layer's momentum m with a zeros / ones
    probe and divides ``(1 - m) * batch`` by ``1 - m``; here every
    ``BatchNorm.momentum`` is set to 0 for the forwards, so each leaves its
    batch moments in the running statistics exactly, whatever its own m.
    ``batches`` yield ``HostBatch``es; ``preprocess`` is
    ``make_preprocess_fn``'s, drawing its augment from ``generator``."""
    device = checked_device(device)
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
        for _ in range(num_batches):
            hb = next(batches).to(device)
            images, _ = preprocess(*hb, generator)
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
        net.train(was_training)
    for bn, (mean, var) in sums.items():
        bn.running_mean.copy_(mean / num_batches)
        bn.running_var.copy_(var / num_batches)
    return net

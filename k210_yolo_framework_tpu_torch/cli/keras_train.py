"""Train a model: the flags, defaults and string booleans of the JAX
package's root ``keras_train.py``, plus ``--device``.

    python -m k210_yolo_framework_tpu_torch.cli.keras_train \
        --train_set voc --model_def yolo_mobilev1 --depth_multiplier 0.75

Reads ``data/<set>_img_ann.npy`` and ``data/<set>_anchor.npy`` and writes,
under ``<log_dir>/<date-time>/``: ``args.txt``; ``scalars.jsonl`` (one line
a step, flushed) and a TensorBoard event file; the weights as
``yolo_model.npz`` (``yolo_prune_model.npz`` with ``--is_prune True``) and
as ``.h5`` too where h5py imports; the whole train state in ``ckpt/``; and
with ``--profile True`` a trace of step 3 in ``profile/``.  ``--pre_ckpt``
takes anything ``training.checkpoint.load_variables`` reads; a ``ckpt/``
directory also resumes the optimizer and the step count.  SIGINT / SIGTERM
end training at a step boundary and the run is saved.

``--mesh dp[,mp[,sp]] | auto`` trains on a mesh, one process a device
(``training.train.fit(mesh=)``: the global batch's step, BatchNorm on the
global batch's statistics): data-parallel over dp, and with mp or sp above
1 (any builder) each rank computes its output channels and rows of the
forward (``parallel/sharded.py``).  ``--bn_recalibrate`` after it runs on
the same ranks, each with the whole net on its data slots, as the JAX
script recalibrates on one device.  Under torchrun each process joins the
world from its environment:

    torchrun --nproc_per_node 4 \
        -m k210_yolo_framework_tpu_torch.cli.keras_train --mesh auto ...

Run plainly, the script starts the ranks itself: ``--mesh auto`` one a
visible card (one process where there is one card), ``--mesh dp,mp,sp``
dp * mp * sp processes (``--device cpu``: gloo ranks on the CPU, ``auto``
one).  A CUDA mesh is NCCL with one card a rank (nothing falls back to
gloo or to the CPU), and the batch must divide by dp.  Only
rank 0 writes the run's files and prints; every rank reads
``--pre_ckpt``, and rank 0's state is the one replicated.
"""

import argparse
import contextlib
import json
import os
import sys
import tempfile
from datetime import datetime
from pathlib import Path


def mesh_dims(text: str) -> list:
    """``--mesh``'s 'dp[,mp[,sp]]' as [dp, mp, sp] (1 for an axis not
    given), or [] for 'auto' / none; more than three axes exit with the
    JAX script's text."""
    dims = [int(x) for x in text.split(",")] \
        if text and text != "auto" else []
    if len(dims) > 3:
        raise SystemExit(f"--mesh {text!r}: format is 'dp,mp[,sp]' "
                         "or 'auto' (at most 3 axes)")
    return dims + [1] * (3 - len(dims)) if dims else []


def _check_divisible(batch_size: int, dp: int, text: str) -> None:
    if batch_size % dp:
        raise SystemExit(f"--batch_size {batch_size} does not divide by the "
                         f"data axis's size {dp} (--mesh {text!r})")


def _run_dir(args) -> Path:
    return Path(args.log_dir) / datetime.now().strftime("%Y%m%d-%H%M%S")


def main(args) -> Path:
    """Train, save, and return the run's directory."""
    import torch
    import torch.distributed as dist

    from k210_yolo_framework_tpu_torch.training import train as T

    if not args.mesh:
        return _train(args, T.checked_device(args.device), _run_dir(args))
    dims = mesh_dims(args.mesh)
    device = T.checked_device(args.device)
    if dist.is_initialized():          # the caller's world
        return _train(args, device, None, joined=True)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:     # torchrun
        return _rank_main(None, None, None, args, None)
    if dims:
        world = dims[0] * dims[1] * dims[2]
    else:
        world = torch.cuda.device_count() if device.type == "cuda" else 1
    if device.type == "cuda" and world > torch.cuda.device_count():
        raise SystemExit(f"--mesh {args.mesh!r}: {world} processes, one a "
                         f"card, but {torch.cuda.device_count()} visible")
    _check_divisible(args.batch_size, dims[0] if dims else world, args.mesh)
    run_dir = _run_dir(args)
    with tempfile.TemporaryDirectory() as tmp:
        spawn = (f"file://{tmp}/init", args, run_dir)
        if world == 1:
            _rank_main(0, 1, *spawn)
        else:
            import torch.multiprocessing as mp

            mp.spawn(_rank_main, args=(world, *spawn), nprocs=world)
    return run_dir


def _rank_main(rank, world, init_method, args, run_dir) -> Path:
    """One rank of a ``--mesh`` run: join the world (from torchrun's
    environment where ``rank`` is None), train, leave."""
    import torch
    import torch.distributed as dist

    from k210_yolo_framework_tpu_torch.parallel import init_world

    if rank is None:
        device = init_world(args.device)
    else:
        device = init_world(args.device, init_method, rank, world)
        if device.type == "cpu" and world > 1:
            # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        return _train(args, device, run_dir, joined=True)
    finally:
        dist.destroy_process_group()


def _train(args, device, run_dir, joined: bool = False) -> Path:
    """The run on ``device``; ``joined``: on a ``--mesh`` over the process
    group this process has joined (``run_dir`` None: rank 0's)."""
    import torch
    import torch.distributed as dist

    from k210_yolo_framework_tpu_torch.cli import str2bool
    from k210_yolo_framework_tpu_torch.config import TrainConfig, YoloSpec
    from k210_yolo_framework_tpu_torch.data import annotations as ANN
    from k210_yolo_framework_tpu_torch.data import pipeline as PL
    from k210_yolo_framework_tpu_torch.models import build_network
    from k210_yolo_framework_tpu_torch.parallel import make_mesh
    from k210_yolo_framework_tpu_torch.training import checkpoint as CK
    from k210_yolo_framework_tpu_torch.training import train as T
    from k210_yolo_framework_tpu_torch.utils import INFO
    from k210_yolo_framework_tpu_torch.utils.tboard import SummaryWriter

    mesh = None
    rank0 = True
    if joined:
        dims = mesh_dims(args.mesh)
        if device.type == "cuda" and dist.get_backend() != "nccl":
            raise RuntimeError(f"--mesh on {device}: the process group is "
                               f"{dist.get_backend()}, not NCCL")
        mesh = make_mesh(*(dims or [None]), device_type=device.type)
        dp = mesh.shape[0]
        _check_divisible(args.batch_size, dp, args.mesh)
        rank0 = dist.get_rank() == 0
        if run_dir is None:            # rank 0 names the run
            name = [str(_run_dir(args))]
            if dist.get_world_size() > 1:
                dist.broadcast_object_list(name, src=0)
            run_dir = Path(name[0])
        print_ = print if rank0 else (lambda *_a, **_k: None)
        print_(INFO, f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
                     f"over {dist.get_world_size()} processes "
                     f"({dist.get_backend()})")
    else:
        print_ = print

    def written() -> None:
        """Rank 0 has written a file of the run: the others wait for it."""
        if mesh is not None:
            dist.barrier()

    log_dir = run_dir
    if rank0:
        log_dir.mkdir(parents=True, exist_ok=True)
        CK.write_args_txt(vars(args), str(log_dir / "args.txt"))
    written()

    spec = YoloSpec.from_files(
        f"data/{args.train_set}_anchor.npy",
        in_hw=tuple(args.image_size),
        out_hws=tuple(args.output_size),
        class_num=args.class_num)

    cfg = TrainConfig(
        batch_size=args.batch_size,
        max_epochs=args.max_nrof_epochs,
        init_learning_rate=args.init_learning_rate,
        learning_rate_decay_factor=args.learning_rate_decay_factor,
        obj_weight=args.obj_weight,
        noobj_weight=args.noobj_weight,
        wh_weight=args.wh_weight,
        obj_thresh=args.obj_thresh,
        iou_thresh=args.iou_thresh,
        validation_split=args.vaildation_split,
        rand_seed=args.rand_seed,
        augment=str2bool(args.augmenter),
        is_prune=str2bool(args.is_prune),
        prune_initial_sparsity=args.prune_initial_sparsity,
        prune_final_sparsity=args.prune_final_sparsity,
        prune_end_epoch=args.prune_end_epoch,
        prune_frequency=args.prune_frequency,
    )

    ann = ANN.load_ann_list(f"data/{args.train_set}_img_ann.npy")
    train_list, test_list = ANN.split_train_test(ann, cfg.validation_split)
    train_pipe = PL.DataPipeline(train_list, cfg.batch_size, cfg.rand_seed)
    if train_pipe.epoch_step == 0:
        raise SystemExit(
            f"train set has {len(train_list)} images < batch_size "
            f"{cfg.batch_size}: zero steps per epoch (drop_remainder "
            "batching, utils.py:449-450) — lower --batch_size")
    test_pipe = (PL.DataPipeline(test_list, cfg.batch_size, cfg.rand_seed)
                 if len(test_list) >= cfg.batch_size else None)

    dtype = {"float32": torch.float32,
             "bfloat16": torch.bfloat16}[args.compute_dtype]
    net = build_network(args.model_def, spec.in_hw, spec.nanchors,
                        spec.class_num, alpha=args.depth_multiplier,
                        generator=torch.Generator().manual_seed(cfg.rand_seed))
    state = T.create_train_state(net, cfg, device)

    if args.pre_ckpt and args.pre_ckpt not in ("None", ""):
        if Path(args.pre_ckpt).is_dir():
            CK.restore_state(args.pre_ckpt, state)
        else:
            net.load_state_dict(CK.load_variables(args.pre_ckpt,
                                                  args.model_def, net))
        print_(INFO, f"Load CKPT {args.pre_ckpt} (step {state.step})")

    pp_train = PL.make_preprocess_fn(spec, is_training=cfg.augment,
                                     dtype=dtype)
    pp_test = PL.make_preprocess_fn(spec, is_training=False, dtype=dtype)

    # per-step scalars: jsonl + a TensorBoard event file, from rank 0
    with contextlib.ExitStack() as stack:
        scalar_logger = None
        if rank0:
            scalar_log = stack.enter_context(
                open(log_dir / "scalars.jsonl", "a"))
            tb = SummaryWriter(str(log_dir))
            stack.callback(tb.close)

            def scalar_logger(step, logs):
                scalar_log.write(json.dumps({"step": step, **logs}) + "\n")
                scalar_log.flush()  # the tail survives a killed run
                tb.add_scalars(list(logs.items()), step)

        state = T.fit(
            net, spec, cfg,
            iter(train_pipe), iter(test_pipe) if test_pipe else None,
            pp_train, pp_test,
            train_pipe.epoch_step,
            test_pipe.epoch_step if test_pipe else 0,
            device=device, compute_dtype=dtype,
            scalar_logger=scalar_logger, state=state,
            profile_dir=(str(log_dir / "profile")
                         if str2bool(args.profile) else ""),
            mesh=mesh)
    written()

    if args.bn_recalibrate > 0:
        print_(INFO, f"recalibrating BN statistics over "
                     f"{args.bn_recalibrate} batches")
        T.recalibrate_batch_stats(net, iter(train_pipe), pp_test,
                                  num_batches=args.bn_recalibrate,
                                  device=device, compute_dtype=dtype,
                                  mesh=mesh)

    stem = log_dir / ("yolo_prune_model" if cfg.is_prune else "yolo_model")
    weights = [f"{stem}.npz"]
    try:
        import h5py  # noqa: F401
    except ImportError:
        pass
    else:
        weights.append(f"{stem}.h5")
    if rank0:
        CK.save_npz(weights[0], net)
        if len(weights) > 1:
            CK.save_h5(weights[1], net)
    written()
    if rank0:
        CK.save_state(str(log_dir / "ckpt"), state)
    written()
    print_(INFO, f"Save Model as {' and '.join(weights)}; train state in "
                 f"{log_dir / 'ckpt'}")
    return log_dir


def parse_args(argv):
    parser = argparse.ArgumentParser()
    parser.add_argument("--train_set", type=str, default="voc")
    parser.add_argument("--class_num", type=int, default=20)
    parser.add_argument("--pre_ckpt", type=str, default="None")
    parser.add_argument("--model_def", type=str, default="yolo_mobilev2")
    parser.add_argument("--depth_multiplier", type=float,
                        choices=[0.5, 0.75, 1.0], default=1.0)
    parser.add_argument("--augmenter", type=str, default="True")
    parser.add_argument("--image_size", type=int, default=(224, 320),
                        nargs="+")
    parser.add_argument("--output_size", type=int, default=(7, 10, 14, 20),
                        nargs="+")
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--rand_seed", type=int, default=6)
    parser.add_argument("--max_nrof_epochs", type=int, default=10)
    parser.add_argument("--init_learning_rate", type=float, default=0.001)
    parser.add_argument("--learning_rate_decay_factor", type=float,
                        default=0)
    parser.add_argument("--obj_weight", type=float, default=5.0)
    parser.add_argument("--noobj_weight", type=float, default=0.5)
    parser.add_argument("--wh_weight", type=float, default=0.5)
    parser.add_argument("--obj_thresh", type=float, default=0.7)
    parser.add_argument("--iou_thresh", type=float, default=0.3)
    parser.add_argument("--vaildation_split", type=float, default=0.1)
    parser.add_argument("--log_dir", type=str, default="log")
    parser.add_argument("--is_prune", type=str, default="False")
    parser.add_argument("--prune_initial_sparsity", type=float, default=0.5)
    parser.add_argument("--prune_final_sparsity", type=float, default=0.9)
    parser.add_argument("--prune_end_epoch", type=int, default=5)
    parser.add_argument("--prune_frequency", type=int, default=100)
    parser.add_argument("--profile", type=str, default="False",
                        help="trace train step 3 with torch.profiler into "
                             "<log_dir>/profile")
    parser.add_argument("--bn_recalibrate", type=int, default=0,
                        help="after training, replace BatchNorm EMA stats "
                             "with arithmetic means over N train batches")
    parser.add_argument("--mesh", type=str, default="",
                        help="'dp[,mp[,sp]]' or 'auto': training on a "
                             "mesh, one process a device")
    parser.add_argument("--compute_dtype", type=str, default="bfloat16",
                        choices=["float32", "bfloat16"],
                        help="conv-stack compute dtype (params and loss "
                             "stay fp32)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' where there is no card")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args(sys.argv[1:]))

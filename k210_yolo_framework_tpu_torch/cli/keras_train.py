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
"""

import argparse
import json
import sys
from datetime import datetime
from pathlib import Path


def main(args) -> Path:
    """Train, save, and return the run's directory."""
    import torch

    from k210_yolo_framework_tpu_torch.cli import str2bool
    from k210_yolo_framework_tpu_torch.config import TrainConfig, YoloSpec
    from k210_yolo_framework_tpu_torch.data import annotations as ANN
    from k210_yolo_framework_tpu_torch.data import pipeline as PL
    from k210_yolo_framework_tpu_torch.models import build_network
    from k210_yolo_framework_tpu_torch.training import checkpoint as CK
    from k210_yolo_framework_tpu_torch.training import train as T
    from k210_yolo_framework_tpu_torch.utils import INFO
    from k210_yolo_framework_tpu_torch.utils.tboard import SummaryWriter

    if args.mesh:
        raise NotImplementedError(
            f"--mesh {args.mesh!r}: multi-GPU training is not ported "
            "(ROADMAP.md, queue 1: multi-GPU)")
    device = T.checked_device(args.device)

    log_dir = Path(args.log_dir) / datetime.now().strftime("%Y%m%d-%H%M%S")
    log_dir.mkdir(parents=True, exist_ok=True)
    CK.write_args_txt(vars(args), str(log_dir / "args.txt"))

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
        print(INFO, f"Load CKPT {args.pre_ckpt} (step {state.step})")

    pp_train = PL.make_preprocess_fn(spec, is_training=cfg.augment,
                                     dtype=dtype)
    pp_test = PL.make_preprocess_fn(spec, is_training=False, dtype=dtype)

    # per-step scalars: jsonl + a TensorBoard event file
    with open(log_dir / "scalars.jsonl", "a") as scalar_log:
        tb = SummaryWriter(str(log_dir))

        def scalar_logger(step, logs):
            scalar_log.write(json.dumps({"step": step, **logs}) + "\n")
            scalar_log.flush()  # the tail survives a killed run
            tb.add_scalars(list(logs.items()), step)

        try:
            state = T.fit(
                net, spec, cfg,
                iter(train_pipe), iter(test_pipe) if test_pipe else None,
                pp_train, pp_test,
                train_pipe.epoch_step,
                test_pipe.epoch_step if test_pipe else 0,
                device=device, compute_dtype=dtype,
                scalar_logger=scalar_logger, state=state,
                profile_dir=(str(log_dir / "profile")
                             if str2bool(args.profile) else ""))
        finally:
            tb.close()

    if args.bn_recalibrate > 0:
        print(INFO, f"recalibrating BN statistics over {args.bn_recalibrate} "
                    "batches")
        T.recalibrate_batch_stats(net, iter(train_pipe), pp_test,
                                  num_batches=args.bn_recalibrate,
                                  device=device, compute_dtype=dtype)

    stem = log_dir / ("yolo_prune_model" if cfg.is_prune else "yolo_model")
    written = [f"{stem}.npz"]
    CK.save_npz(written[0], net)
    try:
        import h5py  # noqa: F401
    except ImportError:
        pass
    else:
        written.append(f"{stem}.h5")
        CK.save_h5(written[1], net)
    CK.save_state(str(log_dir / "ckpt"), state)
    print(INFO, f"Save Model as {' and '.join(written)}; train state in "
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
                        help="not ported: multi-GPU training raises")
    parser.add_argument("--compute_dtype", type=str, default="bfloat16",
                        choices=["float32", "bfloat16"],
                        help="conv-stack compute dtype (params and loss "
                             "stay fp32)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' where there is no card")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args(sys.argv[1:]))

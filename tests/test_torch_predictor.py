"""The port's whole serving slice against the JAX Predictor.

Small spec (64x96 input, 2x3 and 4x6 grids, 3 classes), the same bridged
weights, ``obj_thresh`` low enough that every image has detections, in fp32
and in the bf16 that serving runs.  The two sides letterbox, convolve and
reduce in different orders, so detections are matched as sets with
``utils/detmatch.assert_detections_close``.  In fp32: matched scores within
1e-3, at most one flipped detection per 200.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from k210_yolo_framework_tpu import config as JConfig
from k210_yolo_framework_tpu.inference import Predictor as JaxPredictor
from k210_yolo_framework_tpu.ops import letterbox as JLB
from k210_yolo_framework_tpu.utils import detmatch as JM
from k210_yolo_framework_tpu_torch import config as TConfig
from k210_yolo_framework_tpu_torch.inference import (
    Detections,
    Predictor,
    draw_detections,
    stack_detections,
)
from k210_yolo_framework_tpu_torch.ops import letterbox as LB
from k210_yolo_framework_tpu_torch.training import checkpoint as TC
from k210_yolo_framework_tpu_torch.utils import detmatch as TM
from k210_yolo_framework_tpu_torch.utils.detmatch import assert_detections_close

from test_torch_model import SMALL, jax_net_and_flat, torch_net

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
# the same spec for each package: JSPEC goes to JAX functions, TSPEC to the
# port's
_SPEC_ARGS = (SMALL["in_hw"], ((2, 3), (4, 6)), SMALL["class_num"],
              np.asarray(JConfig.VOC_ANCHORS))
JSPEC = JConfig.YoloSpec.create(*_SPEC_ARGS)
TSPEC = TConfig.YoloSpec.create(*_SPEC_ARGS)
THRESH = dict(obj_thresh=0.2, iou_thresh=0.45)


def _predictors(jax_dtype=jnp.float32, torch_dtype=torch.float32):
    jnet, variables, flat = jax_net_and_flat()
    jp = JaxPredictor(jnet, variables, JSPEC, compute_dtype=jax_dtype,
                      **THRESH)
    tp = Predictor(torch_net(), TC.state_dict_from_flat(flat), TSPEC,
                   compute_dtype=torch_dtype, device="cpu", **THRESH)
    return jp, tp


def _scene(seed=0):
    """Four 72x96 canvases holding images of mixed sizes, and one 50x83
    image."""
    rng = np.random.default_rng(seed)
    hws = np.array([[72, 96], [40, 96], [72, 30], [55, 71]], np.int32)
    canvases = np.zeros((len(hws), 72, 96, 3), np.uint8)
    for b, (h, w) in enumerate(hws):
        canvases[b, :h, :w] = rng.integers(0, 256, (h, w, 3))
    img = rng.integers(0, 256, (50, 83, 3)).astype(np.uint8)
    return canvases, hws, img


def test_predict_batch_and_image_match_jax():
    jp, tp = _predictors()
    canvases, hws, img = _scene()
    want = jp.predict_batch(canvases, hws)
    got = tp.predict_batch(canvases, hws)
    assert len(got) == len(want) == len(hws)
    assert all(len(d.scores) > 0 for d in got)
    n_a, n_b = assert_detections_close(stack_detections(got),
                                       stack_detections(want))
    assert n_a == sum(len(d.scores) for d in got)

    got1, want1 = tp.predict_image(img), jp.predict_image(img)
    assert isinstance(got1, Detections) and len(got1.scores) > 0
    assert_detections_close(stack_detections([got1]),
                            stack_detections([want1]))


def test_bf16_serving_matches_jax():
    """The bf16 program that is served, stage by stage, against the JAX
    Predictor's bf16 program.

    * Letterbox in bf16: the stored uint8 images may differ by one level
      in at most 1% of the pixels (measured: none).  Letterboxing in fp32
      instead moves about 17% of them.
    * Forward in bf16 on the same uint8 images: each head output is
      rounded to bf16 on both sides, so at least 60% of the logits must be
      bitwise equal and the mean absolute difference at most 2.5e-4
      (measured: 70-75% and 1.8e-4).  A rounding point moved (the stem
      scale applied in fp32, or BN started in bf16) gives 37-52% and
      3.4e-4 or more.
    * Detections of predict_batch and predict_image: a logit one bf16 ulp
      apart (2^-8 relative) moves a score by up to 4e-3 and can flip a
      threshold- or IoU-borderline box, so matched scores within 4e-3 and
      at most 2 flips per 100 (measured: 3 of 360, scores within 6.5e-4).
    """
    jp, tp = _predictors(jnp.bfloat16, torch.bfloat16)
    canvases, hws, img = _scene()

    want_lb = np.asarray(jax.vmap(lambda c, hw: JLB.letterbox_image(
        c, hw, JSPEC.in_hw, dtype=jnp.bfloat16).astype(jnp.uint8))(
            jnp.asarray(canvases), jnp.asarray(hws)))
    got_lb = LB.letterbox_image(torch.from_numpy(canvases),
                                torch.from_numpy(hws), TSPEC.in_hw,
                                torch.bfloat16).to(torch.uint8).numpy()
    diff = np.abs(got_lb.astype(np.int16) - want_lb)
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01

    scale = 1.0 / np.maximum(want_lb.reshape(len(hws), -1).max(1), 1)
    want = jp.net.apply(jp.variables, jnp.asarray(want_lb),
                        input_scale=jnp.asarray(scale, jnp.float32))
    with torch.inference_mode():
        got = tp._forward(torch.from_numpy(want_lb.copy()))
    for g, w in zip(got, want):
        assert w.dtype == jnp.bfloat16
        d = np.abs(g.numpy() - np.asarray(w, np.float32))
        assert (d == 0).mean() >= 0.6 and d.mean() <= 2.5e-4, (
            (d == 0).mean(), d.mean())

    bf16_tol = dict(score_tol=4e-3, max_flip_frac=0.02)
    got_b = tp.predict_batch(canvases, hws)
    assert all(len(d.scores) > 0 for d in got_b)
    assert_detections_close(stack_detections(got_b),
                            stack_detections(jp.predict_batch(canvases, hws)),
                            **bf16_tol)
    got1 = tp.predict_image(img)
    assert len(got1.scores) > 0
    assert_detections_close(stack_detections([got1]),
                            stack_detections([jp.predict_image(img)]),
                            **bf16_tol)


def test_detmatch_copy_matches_the_jax_package():
    """The port's matcher gives the JAX package's answers."""
    rng = np.random.default_rng(7)
    b, n = 3, 40
    y0x0 = rng.uniform(0, 80, (2, b, n, 2)).astype(np.float32)
    hw = rng.uniform(2, 30, (2, b, n, 2)).astype(np.float32)
    sets = [stack_detections([Detections(
        np.concatenate([y0x0[k, i], y0x0[k, i] + hw[k, i]], -1),
        rng.uniform(0.2, 1, n).astype(np.float32),
        rng.integers(0, 3, n).astype(np.int32)) for i in range(b)])
        for k in range(2)]
    # half of the second set copies the first, moved by a little
    sets[1].boxes[:, ::2] = sets[0].boxes[:, ::2] + 0.5
    sets[1].scores[:, ::2] = sets[0].scores[:, ::2] + 1e-4
    sets[1].classes[:, ::2] = sets[0].classes[:, ::2]
    for a, c in ((sets[0], sets[1]), (sets[1], sets[0]), (sets[0], sets[0])):
        for kw in ({}, {"iou_min": 0.8, "score_tol": 5e-5}):
            assert TM.match_stats(a, c, **kw) == JM.match_stats(a, c, **kw)
    TM.assert_detections_close(sets[0], sets[0])
    with pytest.raises(AssertionError, match="flipped"):
        TM.assert_detections_close(sets[0], sets[1])


def test_predictor_copies_the_net_and_loads_state():
    _, _, flat = jax_net_and_flat()
    net = torch_net()                       # its own seeded init
    before = {k: v.clone() for k, v in net.state_dict().items()}
    tp = Predictor(net, TC.state_dict_from_flat(flat), TSPEC, device="cpu")
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert torch.equal(tp.net.state_dict()["backbone.stem.bn.running_mean"],
                       torch.from_numpy(flat["batch_stats/backbone/stem/bn/mean"]))


def test_predictor_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU refusal cannot be shown")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(torch_net(), None, TSPEC, device="cuda")


def test_draw_detections_draws_inside_the_frame():
    img = np.zeros((40, 60, 3), np.uint8)
    det = Detections(np.array([[5.0, 5.0, 30.0, np.inf]], np.float32),
                     np.array([0.9], np.float32), np.array([2]))
    out = draw_detections(img, det)
    assert out.shape == img.shape and out.any()


def _chip_smoke_imports():
    """Every import statement of chip_smoke.py, at any depth of its code."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    return [ast.unparse(node) for node in ast.walk(tree)
            if isinstance(node, (ast.Import, ast.ImportFrom))]


def test_port_imports_without_jax():
    """Every module of the port (the native loader's bindings and the
    command-line entry points among them), every module chip_smoke.py
    imports, and the modules the tests' spawned gloo ranks run
    (``tests/torch_parallel_worker.py``, ``torch_parallel_train_worker.py``,
    ``torch_tpsp_worker.py``) import in a fresh interpreter in which importing jax, flax,
    optax, orbax, h5py or matplotlib fails (the card's machine has no flax
    and no h5py: the port imports h5py and matplotlib where it uses them).
    None ends up in sys.modules, and no module of the JAX package
    ``k210_yolo_framework_tpu`` is loaded, not even a numpy-only one."""
    code = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                  "h5py", "matplotlib"):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Block())
import k210_yolo_framework_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for mod in ("native", "models.mobilenet_v2", "models.darknet", "port",
            "anchors.kmeans", "utils.tboard", "utils.console",
            "training.pruning", "cli.keras_train", "cli.keras_inference",
            "cli.keras_eval", "cli.make_anchor_list", "cli.make_voc_list",
            "parallel.mesh", "parallel.sharded"):
    assert f"k210_yolo_framework_tpu_torch.{mod}" in names, names
for name in names:
    importlib.import_module(name)
exec(sys.argv[1])   # chip_smoke.py's import statements
sys.path.insert(0, "tests")
import torch_parallel_worker, torch_parallel_train_worker, torch_tpsp_worker  # noqa: E401,E501 spawned ranks
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "flax", "optax", "orbax", "h5py",
                                    "matplotlib"))
assert not bad, bad
jax_pkg = sorted(m for m in sys.modules
                 if m.split(".")[0] == "k210_yolo_framework_tpu")
assert not jax_pkg, jax_pkg
print(len(names))
"""
    imports = _chip_smoke_imports()
    assert any("k210_yolo_framework_tpu_torch.inference" in i for i in imports)
    proc = subprocess.run([sys.executable, "-c", code, "\n".join(imports)],
                          cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 45

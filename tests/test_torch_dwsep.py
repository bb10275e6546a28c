"""The port's fused depthwise-separable block against the JAX package's.

``fused_dwsep_reference`` (the plain version, which ``fused_dwsep`` runs on
the CPU) against JAX's ``fused_dwsep_reference`` and against JAX's
``fused_dwsep(interpret=True)`` (the Pallas kernel itself, interpreted), on
the shapes of ``tests/test_dwsep_pallas.py`` with its tolerances: fp32
rtol/atol 2e-5, bf16 0.05; in bf16 also at the served net's stride-1
widths and a ragged one, and with NaN in x.  Then a stride-1 block of the
port's eval-mode ``MobileNetV1``, folded by ``block_params``, against the
block itself, and the wrapper's shared-memory search.  The CUDA kernel is
held to the plain version by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from k210_yolo_framework_tpu.ops import dwsep_pallas as JF
from k210_yolo_framework_tpu_torch.models.mobilenet_v1 import MobileNetV1
from k210_yolo_framework_tpu_torch.models.yolonet import init_weights
from k210_yolo_framework_tpu_torch.ops import _build
from k210_yolo_framework_tpu_torch.ops import dwsep_pallas as TF

import test_dwsep_pallas

torch.set_num_threads(1)

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=0.05, atol=0.05)}


def _case(b, h, w, c, cout, seed):
    """tests/test_dwsep_pallas.py's inputs, as fp32 numpy arrays."""
    return [np.asarray(a) for a in test_dwsep_pallas._case(
        b, h, w, c, cout, seed, jnp.float32)]


@functools.lru_cache(maxsize=None)
def _jax_fns(interpret):
    if interpret:
        return jax.jit(functools.partial(JF.fused_dwsep, interpret=True))
    return jax.jit(JF.fused_dwsep_reference)


# the four fp32 shapes and the bf16 shape of tests/test_dwsep_pallas.py
SHAPES = {"d14x20": (2, 14, 20, 48, 96), "d7x10": (1, 7, 10, 96, 96),
          "d28x40": (2, 28, 40, 24, 48), "odd9x13": (1, 9, 13, 16, 24),
          "d14x20c64": (2, 14, 20, 64, 96)}


def _port_and_jax(args, dtype):
    """The port's ``fused_dwsep`` (its plain version, on the CPU) and JAX's
    oracle and interpreted Pallas kernel on the same fp32 numpy inputs, x
    cast to ``dtype`` in both; all three as fp32 numpy arrays."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j_args = (jnp.asarray(args[0]).astype(jdt),
              *(jnp.asarray(a) for a in args[1:]))
    got = TF.fused_dwsep(torch.from_numpy(args[0]).to(tdt),
                         *(torch.from_numpy(a) for a in args[1:]))
    assert got.dtype == tdt
    wants = [np.asarray(_jax_fns(interpret)(*j_args), np.float32)
             for interpret in (False, True)]
    return got.to(torch.float32).numpy(), wants


@pytest.mark.parametrize("dtype,name,seed", [
    *(pytest.param("float32", s, 0, id=f"f32-{s}")
      for s in ("d14x20", "d7x10", "d28x40", "odd9x13")),
    pytest.param("bfloat16", "d14x20c64", 1, id="bf16-d14x20c64"),
    pytest.param("bfloat16", "odd9x13", 1, id="bf16-odd9x13")])
def test_reference_matches_jax(dtype, name, seed):
    shape = SHAPES[name]
    got, wants = _port_and_jax(_case(*shape, seed), dtype)
    assert got.shape == shape[:3] + (shape[4],)
    for interpret, want in zip((False, True), wants):
        np.testing.assert_allclose(got, want, **TOL[dtype],
                                   err_msg=f"interpret={interpret}")


# C -> Cout of the served net's stride-1 blocks (yolo_mobilev1, alpha 0.75:
# block_1, block_3, block_5, blocks 7-11, block_13) and a ragged pair: the
# widths the card's kernel is held to this plain version at
SERVED_WIDTHS = ((24, 48), (96, 96), (192, 192), (384, 384), (768, 768),
                 (20, 36))


@pytest.mark.parametrize("c,cout", SERVED_WIDTHS,
                         ids=[f"{c}to{o}" for c, o in SERVED_WIDTHS])
def test_reference_matches_jax_at_served_widths(c, cout):
    """bf16 at 1x9x13 (117 pixels, not a multiple of the kernel's tile)."""
    got, wants = _port_and_jax(_case(1, 9, 13, c, cout, 5), "bfloat16")
    assert got.shape == (1, 9, 13, cout) and np.isfinite(got).all()
    for interpret, want in zip((False, True), wants):
        np.testing.assert_allclose(got, want, **TOL["bfloat16"],
                                   err_msg=f"interpret={interpret}")


def test_nan_in_x_gives_nan_at_the_same_outputs():
    """A NaN inside the image and one in a corner: NaN at every output
    channel of their 3x3 neighbourhoods (9 + 4 pixels) in the port and in
    both JAX versions; the rest within tolerance."""
    args = _case(1, 9, 13, 24, 48, 6)
    args[0] = args[0].copy()
    args[0][0, 4, 6, 3] = np.nan
    args[0][0, 0, 0, 23] = np.nan
    got, wants = _port_and_jax(args, "bfloat16")
    nan = np.isnan(got)
    assert nan.sum() == (9 + 4) * 48
    assert nan[0, 3:6, 5:8].all() and nan[0, :2, :2].all()
    for interpret, want in zip((False, True), wants):
        np.testing.assert_array_equal(nan, np.isnan(want),
                                      err_msg=f"interpret={interpret}")
        np.testing.assert_allclose(got[~nan], want[~nan], **TOL["bfloat16"],
                                   err_msg=f"interpret={interpret}")


def test_fold_bn_matches_jax():
    rng = np.random.default_rng(2)
    scale, bias, mean = (rng.normal(0, 1, 24).astype(np.float32)
                         for _ in range(3))
    var = rng.uniform(0.3, 2.0, 24).astype(np.float32)
    got = TF.fold_bn(*(torch.from_numpy(a) for a in (scale, bias, mean, var)),
                     1e-3)
    want = JF.fold_bn(*(jnp.asarray(a) for a in (scale, bias, mean, var)),
                      1e-3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


@pytest.fixture(scope="module")
def backbone():
    """A small eval-mode MobileNetV1 (alpha 0.25) whose BN statistics and
    affine terms are redrawn so that no fold is the identity."""
    net = init_weights(MobileNetV1(alpha=0.25),
                       torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for name, t in net.state_dict().items():
            if name.endswith(("running_mean", "bn.bias")):
                t.copy_(torch.from_numpy(rng.normal(0, 0.1, t.shape)))
            elif name.endswith(("running_var", "bn.weight")):
                t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape)))
    return net


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["block_1", "block_7", "block_13"])
def test_folded_block_matches_the_block(backbone, name, dtype):
    """The block's input captured by a forward hook; the fused block on its
    NHWC view against the block's own output.  fp32 rtol/atol 1e-4 (folding
    rounds the BN differently from ``BatchNorm``); bf16 0.05, and the
    plain version is the kernel's stand-in on the CPU."""
    block = getattr(backbone, name)
    tdt = getattr(torch, dtype)
    seen = {}
    hook = block.register_forward_hook(
        lambda mod, args, out: seen.update(x=args[0], y=out))
    rng = np.random.default_rng(4)
    img = torch.from_numpy(rng.uniform(0, 1, (2, 3, 64, 96)).astype(
        np.float32))
    try:
        with torch.inference_mode():
            backbone(img, tdt)
    finally:
        hook.remove()
    x = seen["x"].to(tdt).permute(0, 2, 3, 1)     # NHWC view of the input
    got = TF.fused_dwsep(x, *TF.block_params(block))
    want = seen["y"].permute(0, 2, 3, 1).to(tdt).to(torch.float32)
    tol = TOL[dtype] if dtype == "bfloat16" else dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want.numpy(),
                               **tol)


def test_block_params_refuses_stride_2(backbone):
    with pytest.raises(ValueError, match="stride-1"):
        TF.block_params(backbone.block_2)


def test_fused_dwsep_cpu_path_does_not_launch_and_others_raise():
    args = [torch.from_numpy(a) for a in _case(1, 5, 6, 8, 4, 0)]
    before = TF.fused_dwsep.launches
    TF.fused_dwsep(*args)
    assert TF.fused_dwsep.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        TF.fused_dwsep(*(a.to("meta") for a in args))


def _bf16_footprint(c):
    """The bf16 kernel's shared memory by its definition
    (``csrc/dwsep.cu:smem_bytes``): a 64-pixel tile of K = C rounded up to
    16 plus 8 pad columns and three 32 x (64 + 8) chunks of pw_k, bf16."""
    return 2 * (64 * ((c + 15) // 16 * 16 + 8) + 3 * 32 * 72)


@pytest.mark.parametrize("limit", [0, 48 * 1024, 115_712, 232_448, 10**9])
def test_largest_fitting_matches_a_scan(limit):
    """The wrapper's search for the widest C one block's shared memory
    holds, against a scan of every C: 0 bytes (none fits), the default
    48 KB, two blocks per SM, the H100's opt-in limit, and a limit past
    the search range."""
    hi = 4096
    want = max((c for c in range(hi + 1) if _bf16_footprint(c) <= limit),
               default=0)
    assert _build.largest_fitting(_bf16_footprint, limit, hi) == want
    if 0 < want < hi:
        assert _bf16_footprint(want + 1) > limit

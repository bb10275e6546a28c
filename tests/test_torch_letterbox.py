"""Port letterbox (torch) against the JAX letterbox and the golden warp."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

from k210_yolo_framework_tpu.ops import letterbox as JL
from k210_yolo_framework_tpu_torch.ops import letterbox as TL

import golden

torch.set_num_threads(1)


@pytest.mark.parametrize("img_hw,in_hw", [
    ((375, 500), (224, 320)),   # downscale, pad top/bottom
    ((240, 320), (224, 320)),   # the serving canvas
    ((37, 53), (28, 40)),
    ((100, 41), (224, 320)),    # upscale, pad left/right
])
def test_weight_mat_matches_jax(img_hw, in_hw):
    """The rebuilt resample matrices equal JAX's compute_weight_mat."""
    scale, trans = TL.letterbox_params(torch.tensor([img_hw]), in_hw)
    adj = 0.5 * (1.0 - scale)
    ty, tx = trans[:, 1] + adj, trans[:, 0] + adj
    canvas_hw = (img_hw[0] + 7, img_hw[1] + 5)  # a larger staging canvas
    js, jt = JL.letterbox_params(jnp.asarray(img_hw), in_hw)
    jadj = 0.5 * (1.0 - js)
    for axis, t, jtr in ((0, ty, jt[1] + jadj), (1, tx, jt[0] + jadj)):
        got = TL.weight_mat(canvas_hw[axis], in_hw[axis], scale, t)[0]
        want = compute_weight_mat(canvas_hw[axis], in_hw[axis], js, jtr,
                                  _fill_triangle_kernel, False)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=0)


def test_letterbox_params_truncation():
    hws = torch.tensor([[375, 500], [100, 41]])
    scale, trans = TL.letterbox_params(hws, (224, 320))
    for i, (h, w) in enumerate(hws.tolist()):
        js, jt = JL.letterbox_params(jnp.asarray([h, w]), (224, 320))
        assert float(scale[i]) == float(js)
        np.testing.assert_array_equal(trans[i].numpy(), np.asarray(jt))


def test_letterbox_batch_matches_jax():
    """Batched over mixed per-image sizes in one staging canvas shape;
    within one uint8 level of JAX's fp32 output (trunc turns an ULP of
    summation-order difference into a whole level)."""
    rng = np.random.default_rng(0)
    canvas_hw, in_hw = (60, 80), (28, 40)
    hws = np.array([[60, 80], [37, 53], [60, 21], [13, 80]], np.int32)
    canvases = np.zeros((len(hws), *canvas_hw, 3), np.uint8)
    for b, (h, w) in enumerate(hws):
        canvases[b, :h, :w] = rng.integers(0, 256, (h, w, 3))
    got = TL.letterbox_image(torch.from_numpy(canvases), torch.from_numpy(hws),
                             in_hw).numpy()
    want = np.asarray(jax.vmap(
        lambda c, hw: JL.letterbox_image(c, hw, in_hw))(
            jnp.asarray(canvases), jnp.asarray(hws)))
    assert got.shape == want.shape == (len(hws), *in_hw, 3)
    assert np.abs(got - want).max() <= 1.0
    assert (got == want).mean() > 0.99


def test_letterbox_matches_golden_warp():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    in_hw = (28, 40)
    got = TL.letterbox_image(torch.from_numpy(img)[None],
                             torch.tensor([[37, 53]]), in_hw)[0].numpy()
    want = golden.letterbox_warp(img, in_hw)
    assert (np.abs(got - want) <= 1.0).mean() > 0.995
    assert np.abs(got - want).max() <= 2.0


def test_letterbox_from_staging_canvas():
    """The image alone and the image staged in a zero canvas give the same
    letterbox."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    canvas = np.zeros((64, 64, 3), np.uint8)
    canvas[:37, :53] = img
    hw = torch.tensor([[37, 53]])
    a = TL.letterbox_image(torch.from_numpy(img)[None], hw, (28, 40))
    b = TL.letterbox_image(torch.from_numpy(canvas)[None], hw, (28, 40))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_letterbox_bf16_keeps_integer_levels():
    """In bf16 the pixel products round, but the output is still truncated
    integers in 0..255 (so the uint8 store is exact) and sits within a few
    levels of fp32."""
    rng = np.random.default_rng(2)
    canvases = torch.from_numpy(rng.integers(0, 256, (2, 48, 64, 3))
                                .astype(np.uint8))
    hws = torch.tensor([[48, 64], [30, 50]])
    lo = TL.letterbox_image(canvases, hws, (28, 40), torch.bfloat16)
    hi = TL.letterbox_image(canvases, hws, (28, 40), torch.float32)
    assert lo.dtype == torch.bfloat16
    lo = lo.to(torch.float32)
    assert torch.equal(lo, torch.trunc(lo)) and lo.min() >= 0 and lo.max() <= 255
    assert (lo - hi).abs().max() <= 4.0


def test_normalize_is_whole_image_max():
    out = TL.normalize_image(torch.tensor([[[10.0, 20.0, 200.0]]]))
    np.testing.assert_allclose(out.numpy(), [[[0.05, 0.1, 1.0]]], rtol=1e-6)

"""The port's rotation, augment, preprocess and loader against the JAX
package.

Torch cannot replay ``jax.random``, so each test rebuilds JAX's draws from
the key the way ``augment_batch`` splits it (:func:`jax_draws`) and hands
them to the port as ``AugmentParams``.

Tolerances:
* rotation, plain version against ``rotate_3shear_pallas(interpret=True)``:
  fp32 rtol 1e-6 / atol 1e-4 (XLA contracts some mul+add pairs into FMAs,
  measured 4.6e-5 at most on values up to 255); bf16 within one bf16 ulp
  (both accumulate in fp32 and round once; measured equal);
* against the slice-sum path ``vmap(_rotate_3shear)``: the tolerances of
  ``tests/test_augment.py::test_rotate_pallas_matches_slice_sum`` (fp32
  1e-6 / 1e-4; bf16 rtol 3e-2 / atol 2.5, since that path rounds to bf16
  after every op);
* augment in fp32: images atol 1e-3, boxes rtol 1e-6, ``valid`` exact.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from k210_yolo_framework_tpu import config as JConfig
from k210_yolo_framework_tpu.data import pipeline as JPL
from k210_yolo_framework_tpu.ops import augment as JA
from k210_yolo_framework_tpu.ops import rotate_pallas as JRP
from k210_yolo_framework_tpu_torch import config as TConfig
from k210_yolo_framework_tpu_torch.data import pipeline as TPL
from k210_yolo_framework_tpu_torch.ops import augment as TA
from k210_yolo_framework_tpu_torch.ops import rotate_pallas as TR
from k210_yolo_framework_tpu_torch.ops.codec import pad_boxes

torch.set_num_threads(1)

# the same spec for each package: JSPEC goes to JAX functions, TSPEC to the
# port's
_SPEC_ARGS = ((64, 96), ((2, 3), (4, 6)), 3, np.asarray(JConfig.VOC_ANCHORS))
JSPEC = JConfig.YoloSpec.create(*_SPEC_ARGS)
TSPEC = TConfig.YoloSpec.create(*_SPEC_ARGS)

# jitted JAX entry points, as tests/test_augment.py runs them: op-by-op
# tracing of the slice-built shears costs seconds per call
_pallas_rotate = jax.jit(functools.partial(JRP.rotate_3shear_pallas,
                                           interpret=True))
_slice_rotate = jax.jit(jax.vmap(JA._rotate_3shear))
_jax_augment = jax.jit(JA.augment_batch, static_argnames="mode")


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_draws(key, b: int, hw, mode: str = "stratified") -> TA.AugmentParams:
    """The draws ``augment.augment_batch(key, ...)`` makes, as the port's
    AugmentParams (iid also for b < 3, as JAX falls back)."""
    if mode == "iid" or b < 3:
        keys = jax.random.split(key, b)
        _, branch, do_flip, theta, (tx, ty) = jax.vmap(
            lambda k: JA._branch_matrices(k, hw))(keys)
        perm = np.arange(b)
    else:
        k_perm, k_img = jax.random.split(key)
        perm = jax.random.permutation(k_perm, b)
        keys = jax.random.split(k_img, b)
        do_flip = jax.vmap(lambda k: JA._flip_params(k, hw)[1])(keys)
        theta = jax.vmap(lambda k: JA._rot_params(k, hw)[1])(keys)
        tx, ty = jax.vmap(lambda k: JA._tr_params(k, hw)[1:])(keys)
        lo, mid = b - 2 * (b // 3), b - b // 3
        branch = np.array([0] * lo + [1] * (mid - lo) + [2] * (b - mid))
    return TA.AugmentParams(
        _t(perm).to(torch.int64), _t(branch).to(torch.int64),
        _t(do_flip).to(torch.bool), _t(theta).to(torch.float32),
        _t(tx).to(torch.float32), _t(ty).to(torch.float32))


def test_frame_geometry_matches_jax():
    for h, w in ((224, 320), (96, 96), (24, 32), (48, 200)):
        assert TR.frame_geometry(h, w) == JRP._frame_geometry(h, w, 10.0)
    assert TR.frame_geometry(224, 320) == (12, 32, 288, 344, 14, 31)
    assert TR.frame_geometry(96, 96) == (7, 12, 120, 110, 7, 11)


@pytest.mark.parametrize("h,w,dtype", [(24, 32, "float32"),
                                       (48, 200, "float32"),
                                       (24, 32, "bfloat16")])
def test_rotate_reference_matches_pallas_and_slice_path(h, w, dtype):
    """Includes exactly +-10 degrees, 0 and +-1e-4 rad."""
    rng = np.random.default_rng(7)
    thetas = np.deg2rad(rng.uniform(-10, 10, 6)).astype(np.float32)
    thetas[:5] = [np.deg2rad(10.0), -np.deg2rad(10.0), 0.0, 1e-4, -1e-4]
    jdt = jnp.dtype(dtype)
    imgs = jnp.asarray(rng.uniform(0, 255, (6, h, w, 3)).astype(np.float32)
                       ).astype(jdt)
    tdt = getattr(torch, dtype)
    before = TR.rotate_3shear.launches
    got = TR.rotate_3shear(_t(np.asarray(imgs.astype(jnp.float32))).to(tdt),
                           _t(thetas))
    assert TR.rotate_3shear.launches == before       # CPU: no kernel
    assert got.dtype == tdt and got.shape == imgs.shape
    got = got.float().numpy()
    pallas = np.asarray(_pallas_rotate(imgs, jnp.asarray(thetas)), np.float32)
    sliced = np.asarray(_slice_rotate(imgs, jnp.asarray(thetas)), np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(got, sliced, rtol=1e-6, atol=1e-4)
    else:
        np.testing.assert_allclose(got, pallas, rtol=2.0 ** -8, atol=0)
        np.testing.assert_allclose(got, sliced, rtol=3e-2, atol=2.5)
    # theta == 0 is the identity
    np.testing.assert_array_equal(got[2], np.asarray(imgs[2], np.float32))


def test_rotate_reference_table_arithmetic():
    """The plain version is two taps per output: out = (1-f)*a + f*b with
    f rounded to the image dtype, per line; a whole-pixel shift moves
    pixels exactly."""
    tab = TR.shear_tables(torch.tensor([0.3]), 24, 32, torch.bfloat16)
    f = tab.wx1
    assert torch.equal(f, f.to(torch.bfloat16).float())
    assert torch.equal(tab.wx0, (1 - f.to(torch.bfloat16)).float())
    src = torch.arange(2 * 5 * 7 * 1, dtype=torch.float32).reshape(2, 5, 7, 1)
    k = torch.full((2, 5), 2, dtype=torch.int32)
    out = TR._shift_rows(src, k, torch.ones(2, 5), torch.zeros(2, 5))
    assert torch.equal(out[:, :, 2:], src[:, :, :5])
    assert not out[:, :, :2].any()


def test_rotate_rejects_bad_inputs():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        TR.rotate_3shear(torch.zeros(1, 8, 8, 3, dtype=torch.float64),
                         torch.zeros(1))
    with pytest.raises(ValueError, match="thetas"):
        TR.rotate_3shear(torch.zeros(2, 8, 8, 3), torch.zeros(3))
    with pytest.raises(ValueError, match="no kernel"):
        TR.rotate_3shear(torch.zeros(1, 8, 8, 3, device="meta"),
                         torch.zeros(1, device="meta"))


# H100 SXM: the per-block opt-in limit, and a third of the SM's less the
# per-block reservation (the plan for three blocks an SM), both less the
# kernel's 16 bytes of static shared memory; and the 48 KB default
SMEM_LIMITS = (232_432, 76_784, 48 * 1024)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w", [(8, 8), (96, 96), (224, 320), (416, 416)])
def test_rotate_tile_plan_fits_and_covers_ten_degrees(h, w, dtype):
    """The tile fits each limit, and its staged columns cover what its
    outputs read at +-10 degrees (tables of ``dtype``) in every band of
    rows, so the kernel never takes its unstaged path there."""
    _, _, hp, wp, _, _ = TR.frame_geometry(h, w)
    px, py = TR.frame_geometry(h, w)[:2]
    tables = TR.shear_tables(torch.tensor(np.deg2rad([10.0, -10.0, 3.0]),
                                          dtype=torch.float32), h, w, dtype)
    kx = tables.kx[:, py:py + h]
    for limit in SMEM_LIMITS:
        tile = TR.plan_tile(h, w, 3, limit)
        assert 1 <= tile.rows <= h and 1 <= tile.cols <= w
        assert tile.staged == TR.staged_columns(tile.rows, tile.cols, wp)
        assert TR.smem_bytes(tile.rows, tile.staged, 3, hp) <= limit
        for y0 in range(0, h, tile.rows):
            band = kx[:, y0:y0 + tile.rows]
            spread = band.amax(1) - band.amin(1)
            assert int(spread.max()) + min(tile.cols, w) + 1 <= tile.staged \
                or tile.staged == wp
    with pytest.raises(ValueError, match="fits"):
        TR.plan_tile(h, w, 3, TR.smem_bytes(1, 3, 3, hp) - 1)


def _rot_args(n=2, h=24, w=32):
    imgs = torch.zeros((n, h, w, 3))
    return imgs, TR.shear_tables(torch.zeros(n), h, w, torch.float32)


@pytest.mark.parametrize("case,match", [
    ("strided", "contiguous"), ("half", "float32 or bfloat16"),
    ("kx_rows", "kx"), ("wy0_device", "wy0"), ("ky_dtype", "ky"),
    ("tile", "tile"), ("frame", "32 bits")])
def test_rotate_kernel_wrapper_rejects_bad_inputs_before_launch(case, match):
    """The kernel's wrapper checks what it is given before it builds or
    launches anything, so each refusal shows here on the CPU."""
    imgs, tables = _rot_args()
    tile = None
    if case == "strided":
        imgs = imgs.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "half":
        imgs = imgs.half()
    elif case == "kx_rows":
        tables = tables._replace(kx=tables.kx[:, 1:].contiguous())
    elif case == "wy0_device":
        tables = tables._replace(wy0=tables.wy0.to("meta"))
    elif case == "ky_dtype":
        tables = tables._replace(ky=tables.ky.long())
    elif case == "tile":
        tile = (25, 8)
    else:                     # a frame past 32-bit indexing
        imgs = torch.empty((1, 26000, 26000, 3), device="meta")
        tables = TR.shear_tables(torch.zeros(1, device="meta"), 26000, 26000,
                                 torch.float32)
    with pytest.raises(ValueError, match=match):
        TR._launch(imgs, tables, tile)


def _aug_inputs(b, seed=0, hw=(24, 32)):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 255, (b, *hw, 3)).astype(np.float32)
    boxes = np.concatenate([rng.integers(0, 3, (b, 6, 1)),
                            rng.uniform(0.05, 0.95, (b, 6, 2)),
                            rng.uniform(0.05, 0.6, (b, 6, 2))], -1).astype(
                                np.float32)
    boxes[0, 0, 1:3] = [0.02, 0.98]            # near a corner: clipped
    valid = rng.uniform(size=(b, 6)) < 0.8
    return imgs, boxes, valid


@pytest.mark.parametrize("mode,b", [("stratified", 7), ("iid", 6),
                                    ("stratified", 2)])
def test_augment_batch_matches_jax(mode, b):
    imgs, boxes, valid = _aug_inputs(b)
    key = jax.random.PRNGKey(11)
    want = _jax_augment(key, jnp.asarray(imgs), jnp.asarray(boxes),
                        jnp.asarray(valid), mode=mode)
    params = jax_draws(key, b, imgs.shape[1:3], mode)
    if mode == "iid":
        assert len(set(params.branch.tolist())) > 1
    got = TA.augment_batch(_t(imgs), _t(boxes), _t(valid), params=params)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_augment_draws_from_the_generator():
    """Same seed, same augment; the stratified split is ceil/floor/floor;
    the draws stay inside the reference's ranges."""
    imgs, boxes, valid = _aug_inputs(128, hw=(8, 12))
    p = TA.draw_params(128, (8, 12), generator=torch.Generator().manual_seed(3))
    assert p.branch.tolist() == [0] * 44 + [1] * 42 + [2] * 42
    assert sorted(p.perm.tolist()) == list(range(128))
    assert p.theta.abs().max() <= np.deg2rad(10.0) + 1e-7
    assert p.tx.abs().max() <= 1.2 + 1e-6 and p.ty.abs().max() <= 0.8 + 1e-6
    a = TA.augment_batch(_t(imgs), _t(boxes), _t(valid),
                         generator=torch.Generator().manual_seed(3))
    b = TA.augment_batch(_t(imgs), _t(boxes), _t(valid), params=p)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert TA.draw_params(2, (8, 12)).perm.tolist() == [0, 1]   # iid
    with pytest.raises(ValueError, match="mode"):
        TA.draw_params(6, (8, 12), mode="nope")


@functools.lru_cache(maxsize=None)
def _host_batch():
    """Four 72x96 canvases of mixed image sizes with padded boxes."""
    rng = np.random.default_rng(2)
    hws = np.array([[72, 96], [40, 96], [72, 30], [55, 71]], np.int32)
    canvases = np.zeros((4, 72, 96, 3), np.uint8)
    for b, (h, w) in enumerate(hws):
        canvases[b, :h, :w] = rng.integers(0, 256, (h, w, 3))
    boxes, valid = zip(*(pad_boxes(np.concatenate(
        [rng.integers(0, 3, (n, 1)), rng.uniform(0.2, 0.8, (n, 2)),
         rng.uniform(0.1, 0.4, (n, 2))], -1)) for n in (3, 1, 5, 2)))
    return TPL.HostBatch(canvases, hws, np.stack(boxes), np.stack(valid))


@pytest.mark.parametrize("is_training", [False, True])
def test_preprocess_matches_jax(is_training):
    """fp32 letterbox -> augment -> /max -> encode on one HostBatch.  The
    letterbox may move a pixel by one uint8 level (tests/
    test_torch_letterbox.py), i.e. 1/max after normalising.  Labels are
    held at rtol 1e-6: under jit XLA may fuse the box map's mul+add into an
    FMA, one fp32 ulp off the op-by-op value (measured: 1 of 576)."""
    hb = _host_batch()
    key = jax.random.PRNGKey(5)
    want_imgs, want_labels = JPL.make_preprocess_fn(JSPEC, is_training)(
        *map(jnp.asarray, hb), key)
    params = jax_draws(key, 4, JSPEC.in_hw) if is_training else None
    got_imgs, got_labels = TPL.make_preprocess_fn(TSPEC, is_training)(
        *hb.to("cpu"), params=params)
    got, want = got_imgs.numpy(), np.asarray(want_imgs)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1.0 / 255 + 1e-6
    assert (np.abs(got - want) <= 1e-6).mean() > 0.99
    for g, w in zip(got_labels, want_labels):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0)


def test_preprocess_bf16_pixels_fp32_labels():
    hb = _host_batch()
    pp = TPL.make_preprocess_fn(TSPEC, True, dtype=torch.bfloat16)
    imgs, labels = pp(*hb.to("cpu"), generator=torch.Generator().manual_seed(0))
    assert imgs.dtype == torch.bfloat16 and imgs.shape == (4, 64, 96, 3)
    assert float(imgs.float().amax()) == 1.0
    assert all(lab.dtype == torch.float32 for lab in labels)


@pytest.fixture(scope="module")
def ann(tmp_path_factory):
    jdir = tmp_path_factory.mktemp("jax_synth")
    tdir = tmp_path_factory.mktemp("torch_synth")
    return (JPL.synthetic_ann_list(str(jdir), n=7, class_num=3, seed=1),
            TPL.synthetic_ann_list(str(tdir), n=7, class_num=3, seed=1))


def test_loader_yields_the_jax_loaders_batches(ann):
    """Same rows and files from synthetic_ann_list; each loader, the
    thread path (``use_native=False``) and the C++ one (``use_native=True``),
    yields the JAX package's batches for the same seed and path."""
    from k210_yolo_framework_tpu import native as jnative

    jann, tann = ann
    for jr, tr in zip(jann, tann):
        np.testing.assert_array_equal(jr[1], tr[1])
        np.testing.assert_array_equal(jr[2], tr[2])
    if not jnative.available():   # one retry past another process's make
        jnative._libs.clear()
    for use_native in (False, True):
        jit = iter(JPL.DataPipeline(jann, 3, seed=4, canvas_hw=(512, 512),
                                    num_workers=2, use_native=use_native))
        tit = iter(TPL.DataPipeline(tann, 3, seed=4, num_workers=2,
                                    use_native=use_native))
        for _ in range(3):                # crosses an epoch boundary
            for a, b in zip(next(jit), next(tit)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        jit.close()
        tit.close()

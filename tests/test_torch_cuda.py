"""The port's CUDA kernels against their plain PyTorch versions, on a GPU:
the fused decode+NMS head, NMS alone, the fused depthwise-separable block
and the augment's 3-shear rotation; each builder served on the card
through the head kernel; a train step of each builder on the card against
the same step on the CPU; and the build naming a new library when only
the shared header changes; the conv epilogue against its plain version
bit for bit, and each builder served through it bit for bit against the
plain path.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports nothing of JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Head tolerances are those of ``tests/test_yolo_head_pallas.py``; ``valid``
may differ only where a score lies within 1e-5 of the threshold.  The
rotation kernel must equal its plain version bit for bit (both take the
same per-line tables and round alike), and so must the NMS kernel (the
same selection loop, no transcendental function).  The dwsep kernel rounds
at other places than its plain version: fp32 rtol/atol 2e-5, bf16 0.05
(``tests/test_dwsep_pallas.py``'s tolerances).
"""

import copy
import shutil

import numpy as np
import pytest
import torch

from k210_yolo_framework_tpu_torch.config import (
    VOC_ANCHORS,
    TrainConfig,
    YoloSpec,
    voc_spec,
)
from k210_yolo_framework_tpu_torch.inference import Predictor
from k210_yolo_framework_tpu_torch.models import build_network
from k210_yolo_framework_tpu_torch.models.layers import smooth_witness
from k210_yolo_framework_tpu_torch.ops import _build
from k210_yolo_framework_tpu_torch.ops import augment as TA
from k210_yolo_framework_tpu_torch.ops import decode as TD
from k210_yolo_framework_tpu_torch.ops import dwsep_pallas as TF
from k210_yolo_framework_tpu_torch.ops import nms_pallas as TN
from k210_yolo_framework_tpu_torch.ops import rotate_pallas as TR
from k210_yolo_framework_tpu_torch.ops import yolo_head_pallas as TH
from k210_yolo_framework_tpu_torch.ops.nms import finish_winners
from k210_yolo_framework_tpu_torch.training import train as TT

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _preds(spec, bsz, seed, shift=0.0):
    rng = np.random.default_rng(seed)
    out = []
    for h, w in spec.out_hws:
        p = rng.normal(0, 2, (bsz, h, w, spec.nanchors, 5 + spec.class_num))
        p[..., 4:] += shift
        out.append(p.astype(np.float32))
    return out


def _own_capacity(dev) -> int:
    """The most candidates both greedy kernels hold in shared memory."""
    return min(
        TN.own_capacity(TH._kernel_lib().yolo_head_smem_bytes,
                        TH._smem_limit(dev)),
        TN.own_capacity(TN._kernel_lib().nms_smem_bytes,
                        TN._smem_limit(dev)))


def _close(got, want, thresh):
    g = [t.cpu().numpy() for t in got]
    w = [t.cpu().numpy() for t in want]
    flip = g[3] != w[3]
    near = np.abs(np.where(g[3], g[1], w[1])[flip] - thresh)
    assert (near <= 1e-5).all(), f"{int(flip.sum())} valid flips"
    both = g[3] & w[3]
    np.testing.assert_array_equal(g[2], w[2])
    np.testing.assert_allclose(g[1][both], w[1][both], rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(g[0][both], w[0][both], rtol=1e-3, atol=0.05)


@pytest.mark.parametrize("class_softmax,thresh", [(False, 0.7), (True, 0.03)])
@pytest.mark.parametrize("case", ["sparse", "dense", "nan"])
def test_kernel_matches_plain(dev, case, class_softmax, thresh):
    spec = voc_spec()
    preds = _preds(spec, 16, seed=0, shift=3.0 if case == "dense" else 0.0)
    if case == "nan":
        preds[0][0] = np.nan
        preds[1][1, 3, 4, 0, 8] = np.nan
    preds = [torch.from_numpy(p).to(dev) for p in preds]
    hws = torch.from_numpy(np.random.default_rng(1).integers(
        100, 512, (16, 2)).astype(np.int32)).to(dev)
    before = TH.fused_decode_nms.launches
    ordered = TH.fused_decode_nms.ordered_launches
    got = TH.fused_decode_nms(preds, spec, hws, thresh, 0.3, 30, class_softmax)
    torch.cuda.synchronize()
    assert TH.fused_decode_nms.launches == before + 1
    assert TH.fused_decode_nms.ordered_launches == ordered
    want = TH.fused_decode_nms_reference(preds, spec, hws, thresh, 0.3, 30,
                                         class_softmax)
    _close(got, want, thresh)
    if case == "nan":
        assert not got.valid[0].any()


def test_kernel_three_scale_large_shared_memory(dev):
    """4410 candidates need 88 KB of shared memory per block (above the
    48 KB default)."""
    rng = np.random.default_rng(2)
    anchors = np.sort(rng.uniform(0.05, 0.9, (3, 3, 2)))[:, ::-1]
    spec = YoloSpec.create((224, 320), ((7, 10), (14, 20), (28, 40)), 20,
                           anchors)
    preds = [torch.from_numpy(p).to(dev) for p in _preds(spec, 8, seed=3)]
    hws = torch.tensor([[224, 320]] * 8, dtype=torch.int32, device=dev)
    got = TH.fused_decode_nms(preds, spec, hws, 0.7, 0.3, 30)
    want = TH.fused_decode_nms_reference(preds, spec, hws, 0.7, 0.3, 30)
    _close(got, want, 0.7)


def test_wrapper_rejects_bad_inputs(dev):
    spec = voc_spec()
    p = torch.zeros((2, 1050, 25), device=dev)
    geom = TH._geometry_on(spec, p.device)
    lbox = torch.ones((2, 8), device=dev)
    kw = dict(classes=20, max_out=30, iou_thresh=0.3, score_thresh=0.7,
              class_softmax=False)
    with pytest.raises(ValueError, match="float32"):
        TH._launch(p.double(), geom, lbox, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        TH._launch(p.transpose(0, 1).contiguous().transpose(0, 1), geom,
                   lbox, **kw)
    with pytest.raises(ValueError, match="shape"):
        TH._launch(p, geom, lbox[:1], **kw)
    lib = TH._kernel_lib()
    for n, g in ((1, 1), (1050, 1), (1050, 2), (1050, 20), (4410, 5),
                 (11618, 1), (8937, 1), (3, 32)):
        assert lib.yolo_head_smem_bytes(n, g) == _greedy_footprint(n, g)
    limit = TN.own_capacity(lib.yolo_head_smem_bytes, TH._smem_limit(dev))
    assert _greedy_footprint(limit, 1) <= TH._smem_limit(dev) \
        < _greedy_footprint(limit + 1, 1)
    optin = getattr(torch.cuda.get_device_properties(dev),
                    "shared_memory_per_block_optin", None)
    if optin is not None:
        assert TH._smem_limit(dev) <= optin
        if optin >= 232_448:          # an H100's: every N taken before
            assert limit >= 11_618
    with pytest.raises(ValueError, match="shared memory"):
        TH._launch(p, geom, lbox, rows=33, **kw)
    big = torch.zeros((1, limit + 1, 25), device=dev)
    # a forced G must fit shared memory; the planned path takes any N
    with pytest.raises(ValueError, match="shared memory"):
        TH._launch(big, torch.zeros((8, limit + 1), device=dev),
                   lbox[:1].contiguous(), rows=1, **kw)
    # the largest candidate count a block holds stays in shared memory, one
    # more goes to the global path
    assert TH._plan(dev, 1, limit, 20) == ("own", 1)
    assert TH._plan(dev, 1, limit + 1, 20)[0] == "global"
    before = TH.fused_decode_nms.global_launches
    ordered = TH.fused_decode_nms.ordered_launches
    TH._launch(big[:, :limit].contiguous(), torch.zeros((8, limit), device=dev),
               lbox[:1].contiguous(), **kw)
    TH._launch(big, torch.zeros((8, limit + 1), device=dev),
               lbox[:1].contiguous(), **kw)
    torch.cuda.synchronize()
    assert TH.fused_decode_nms.global_launches == before + 1
    # the global path selects in score order, the shared layouts never
    assert TH.fused_decode_nms.ordered_launches == ordered + 1
    with pytest.raises(ValueError, match="layout"):
        TH._launch(p, geom, lbox, layout="shared", **kw)
    with pytest.raises(ValueError, match="ordered"):
        TH._launch(p, geom, lbox, ordered=True, **kw)
    for thresh in (-1e9, -1e9 + 1.0, float("nan")):
        # -1e9 + 1 rounds to -1e9 in float32: the step loop's rule
        with pytest.raises(ValueError, match="no ordered path"):
            TH._launch(big, torch.zeros((8, limit + 1), device=dev),
                       lbox[:1].contiguous(), layout="global", ordered=True,
                       **{**kw, "score_thresh": thresh})


def test_predictor_on_card_uses_the_kernel(dev):
    spec = voc_spec()
    net = build_network("yolo_mobilev1", spec.in_hw, 3, 20, alpha=0.75,
                        generator=torch.Generator().manual_seed(0))
    pred = Predictor(net, None, spec, obj_thresh=0.2,
                     compute_dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(4)
    canvases = rng.integers(0, 256, (4, 240, 320, 3)).astype(np.uint8)
    hws = np.array([[240, 320], [200, 300], [240, 100], [120, 320]], np.int32)
    before = TH.fused_decode_nms.launches
    dets = pred.predict_batch(canvases, hws)
    assert TH.fused_decode_nms.launches == before + 1
    assert len(dets) == 4
    c = torch.from_numpy(canvases).to(dev)
    h = torch.from_numpy(hws).to(dev)
    preds = pred._forward_batch(c, h)
    _close(pred._head(preds, h),
           TH.fused_decode_nms_reference(preds, spec, h, 0.2, 0.3, 30), 0.2)


def test_run_batch_replays_from_a_cuda_graph_bit_for_bit(dev):
    """``_run_batch`` (letterbox, bf16 net, the head kernel) captured in a
    CUDA graph after a warm-up, then replayed on two other batches copied
    into its input: every result field equals the eager call's bit for
    bit (what ``bench --mode serve_scan`` replays)."""
    spec = voc_spec()
    net = build_network("yolo_mobilev1", spec.in_hw, 3, 20, alpha=0.75,
                        generator=torch.Generator().manual_seed(0))
    pred = Predictor(net, None, spec, obj_thresh=0.25,
                     compute_dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(6)

    def batch():
        c = rng.integers(0, 256, (8, 240, 320, 3)).astype(np.uint8)
        h = np.stack([rng.integers(60, 241, 8), rng.integers(60, 321, 8)],
                     -1).astype(np.int32)
        return torch.from_numpy(c).to(dev), torch.from_numpy(h).to(dev)

    static_c, static_h = batch()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        pred._run_batch(static_c, static_h)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = pred._run_batch(static_c, static_h)
    for _ in range(2):
        c, h = batch()
        static_c.copy_(c)
        static_h.copy_(h)
        graph.replay()
        want = pred._run_batch(c, h)
        assert int(want.valid.sum()) > 0
        for field, got, ref in zip(want._fields, captured, want):
            assert torch.equal(got, ref), field


# (builder, alpha, spec): yolo_mobilev2 at the Makefile's DEPTHMUL, tiny_yolo,
# and the darknet53 yolo on three scales
BUILDERS = [("yolo_mobilev2", 0.75, 2), ("tiny_yolo", 1.0, 2),
            ("yolo", 1.0, 3)]


def _builder_spec(layers, in_hw=(224, 320), classes=20):
    if layers == 2:
        return YoloSpec.create(in_hw, ((in_hw[0] // 32, in_hw[1] // 32),
                                       (in_hw[0] // 16, in_hw[1] // 16)),
                               classes, np.asarray(VOC_ANCHORS))
    rng = np.random.default_rng(2)
    anchors = np.sort(rng.uniform(0.05, 0.9, (3, 3, 2)))[:, ::-1]
    return YoloSpec.create(in_hw, tuple((in_hw[0] // s, in_hw[1] // s)
                                        for s in (32, 16, 8)),
                           classes, anchors)


@pytest.mark.parametrize("name,alpha,layers", BUILDERS)
def test_builder_served_on_card_through_the_kernel(dev, name, alpha, layers):
    """Seeded weights, bf16, B=4: one head launch per predict_batch call,
    and the kernel's detections equal the plain head's on the same
    logits."""
    spec = _builder_spec(layers)
    net = build_network(name, spec.in_hw, 3, 20, alpha=alpha,
                        generator=torch.Generator().manual_seed(0))
    pred = Predictor(net, None, spec, obj_thresh=0.2,
                     compute_dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(4)
    canvases = rng.integers(0, 256, (4, 240, 320, 3)).astype(np.uint8)
    hws = np.array([[240, 320], [200, 300], [240, 100], [120, 320]], np.int32)
    before = TH.fused_decode_nms.launches
    dets = pred.predict_batch(canvases, hws)
    assert TH.fused_decode_nms.launches == before + 1 and len(dets) == 4
    c = torch.from_numpy(canvases).to(dev)
    h = torch.from_numpy(hws).to(dev)
    preds = pred._forward_batch(c, h)
    assert [tuple(p.shape[1:3]) for p in preds] == list(spec.out_hws)
    _close(pred._head(preds, h),
           TH.fused_decode_nms_reference(preds, spec, h, 0.2, 0.3, 30), 0.2)


@pytest.mark.parametrize("name,alpha,layers", BUILDERS)
def test_builder_train_step_on_card_matches_cpu(dev, name, alpha, layers):
    """One fp32 train step at 96x128, B=2, TF32 off, card against CPU from
    the same weights, on the smooth witness: losses rtol 1e-4, every
    gradient within 1e-3 of its own largest entry, except v2's project BN
    biases (a 1x1 conv and a train-mode BN follow them, so their exact
    gradient is 0), which stay below 1e-6 of the largest gradient entry on
    both."""
    spec = _builder_spec(layers, (96, 128), classes=3)
    cfg = TrainConfig(batch_size=2)
    rng = np.random.default_rng(7)
    images = torch.from_numpy(rng.uniform(0, 1, (2, 96, 128, 3)).astype(
        np.float32))
    labels = [torch.zeros((2, h, w, 3, 8)) for h, w in spec.out_hws]
    labels[-1][:, 1, 2, 0, :5] = torch.tensor([0.4, 0.3, 0.2, 0.3, 1.0])
    labels[-1][:, 1, 2, 0, 6] = 1.0
    grads, logs = [], []
    for device in ("cpu", dev):
        net = smooth_witness(build_network(
            name, spec.in_hw, 3, 3, alpha=alpha,
            generator=torch.Generator().manual_seed(0)))
        state = TT.create_train_state(net, cfg, device)
        state, lg = TT.make_train_step(spec, cfg)(
            state, images.to(device), [l.to(device) for l in labels])
        grads.append({n: p.grad.cpu() for n, p in
                      state.net.named_parameters()})
        logs.append(lg)
    for k in ["loss"] + [f"l{i + 1}_loss" for i in range(layers)]:
        np.testing.assert_allclose(float(logs[1][k]), float(logs[0][k]),
                                   rtol=1e-4, err_msg=k)
    top = max(float(g.abs().max()) for g in grads[0].values())
    for n, g0 in grads[0].items():
        g1 = grads[1][n]
        if n.endswith("project.bn.bias"):
            assert max(float(g0.abs().max()), float(g1.abs().max())) \
                <= 1e-6 * top, n
            continue
        scale = float(g0.abs().max())
        assert float((g1 - g0).abs().max()) <= 1e-3 * scale + 1e-12, n


@pytest.mark.parametrize("n,h,w,c,dtype", [
    (42, 224, 320, 3, torch.float32), (42, 224, 320, 3, torch.bfloat16),
    (6, 96, 96, 3, torch.float32), (3, 24, 32, 3, torch.bfloat16),
    (3, 8, 8, 3, torch.float32), (3, 61, 97, 3, torch.float32),   # odd
    (4, 416, 416, 3, torch.bfloat16), (3, 40, 50, 1, torch.float32),
    (3, 33, 45, 4, torch.bfloat16), (3, 7000, 16, 3, torch.float32)])
def test_rotate_kernel_matches_plain_bit_for_bit(dev, n, h, w, c, dtype):
    """+-10 degrees, 0 and random angles; 416x416 runs tiles of fewer rows
    than the image at every row band; 7000x16 has x tables too tall for
    three blocks an SM."""
    rng = np.random.default_rng(5)
    imgs = torch.from_numpy(rng.uniform(0, 255, (n, h, w, c)).astype(
        np.float32)).to(dev).to(dtype)
    thetas = np.deg2rad(rng.uniform(-10, 10, n)).astype(np.float32)
    thetas[:3] = [np.deg2rad(10.0), -np.deg2rad(10.0), 0.0]
    thetas = torch.from_numpy(thetas).to(dev)
    before = TR.rotate_3shear.launches
    got = TR.rotate_3shear(imgs, thetas)
    torch.cuda.synchronize()
    assert TR.rotate_3shear.launches == before + 1
    tables = TR.shear_tables(thetas, h, w, dtype)
    want = TR._rotate_plain(imgs, tables)
    assert got.dtype == dtype and got.shape == imgs.shape
    assert torch.equal(got, want)
    assert torch.equal(got[2], imgs[2])          # theta 0
    if h == 416:
        assert TR.plan_tile(h, w, c, TR.smem_limit(dev)).rows < h


@pytest.mark.parametrize("tile", [(1, 1), (5, 7), (16, 320), (224, 40),
                                  (37, 129)])
def test_rotate_kernel_forced_tiles_bit_for_bit(dev, tile):
    """Tiles cut unevenly at the image's right and bottom edges."""
    rng = np.random.default_rng(9)
    imgs = torch.from_numpy(rng.uniform(-255, 255, (5, 224, 320, 3)).astype(
        np.float32)).to(dev)
    thetas = torch.tensor(np.deg2rad([10.0, -10.0, 0.0, 4.2, -7.7]),
                          dtype=torch.float32, device=dev)
    tables = TR.shear_tables(thetas, 224, 320, torch.float32)
    got = TR._launch(imgs, tables, tile)
    torch.cuda.synchronize()
    assert torch.equal(got, TR._rotate_plain(imgs, tables))


def test_rotate_kernel_any_table_bit_for_bit(dev):
    """Angles past 10 degrees, and offsets far outside the frame (down to
    the int32 limits), spread the x offsets past the staged columns: those
    taps take the unstaged path, with the same result."""
    rng = np.random.default_rng(10)
    imgs = torch.from_numpy(rng.uniform(0, 255, (4, 48, 64, 3)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    thetas = torch.tensor(np.deg2rad([30.0, -45.0, 89.0, -170.0]),
                          dtype=torch.float32, device=dev)
    tables = TR.shear_tables(thetas, 48, 64, torch.bfloat16)
    kx, ky = tables.kx.clone(), tables.ky.clone()
    kx[3, ::3], kx[3, 1::5], kx[3, 2::7] = -2 ** 31, 2 ** 31 - 1, 37
    ky[3, ::4], ky[3, 1::6], ky[3, 3::5] = 2 ** 31 - 1, -2 ** 31, -25
    tables = tables._replace(kx=kx, ky=ky)
    for tile in (None, (8, 10)):
        got = TR._launch(imgs, tables, tile)
        torch.cuda.synchronize()
        assert torch.equal(got, TR._rotate_plain(imgs, tables))


def test_rotate_footprint_and_plan_match_the_library(dev):
    lib = TR._kernel_lib()
    for rows, staged, c, hp in ((32, 165, 3, 288), (1, 3, 1, 5),
                                (224, 60, 4, 498)):
        assert lib.rotate3shear_smem_bytes(rows, staged, c, hp) == \
            TR.smem_bytes(rows, staged, c, hp)
    two, one = TR.smem_limit(dev), TR.smem_limit(dev, 1)
    assert 0 < two < one
    for h, w in ((224, 320), (416, 416), (96, 96), (8, 8)):
        tile = TR.plan_tile(h, w, 3, two)
        hp = TR.frame_geometry(h, w)[2]
        assert TR.smem_bytes(tile.rows, tile.staged, 3, hp) <= two


def test_rotate_wrapper_rejects_bad_inputs(dev):
    imgs = torch.zeros((2, 24, 32, 3), device=dev)
    tables = TR.shear_tables(torch.zeros(2, device=dev), 24, 32,
                             torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        TR._launch(imgs.transpose(1, 2).contiguous().transpose(1, 2), tables)
    with pytest.raises(ValueError, match="kx"):
        TR._launch(imgs, tables._replace(kx=tables.kx[:1]))
    with pytest.raises(ValueError, match="wy0"):
        TR._launch(imgs, tables._replace(wy0=tables.wy0.cpu()))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        TR.rotate_3shear(imgs.half(), torch.zeros(2, device=dev))


def test_augment_on_card_runs_the_kernel_once(dev):
    rng = np.random.default_rng(6)
    imgs = torch.from_numpy(rng.uniform(0, 255, (9, 64, 96, 3)).astype(
        np.float32))
    boxes = torch.from_numpy(np.concatenate(
        [rng.integers(0, 3, (9, 4, 1)), rng.uniform(0.2, 0.8, (9, 4, 2)),
         rng.uniform(0.1, 0.4, (9, 4, 2))], -1).astype(np.float32))
    valid = torch.ones((9, 4), dtype=torch.bool)
    params = TA.draw_params(9, (64, 96),
                            generator=torch.Generator().manual_seed(1))
    before = TR.rotate_3shear.launches
    got = TA.augment_batch(imgs.to(dev), boxes.to(dev), valid.to(dev),
                           params=params)
    torch.cuda.synchronize()
    assert TR.rotate_3shear.launches == before + 1
    want = TA.augment_batch(imgs, boxes, valid, params=params)
    # the rotation's tables come from tan / sin on each device, which may
    # differ by an ulp: images atol 1e-3, as the CPU tests hold JAX
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(),
                               rtol=0, atol=1e-3)
    for g, w_ in zip(got[1:], want[1:]):
        assert torch.equal(g.cpu(), w_)


def test_train_step_on_card_matches_cpu(dev):
    """One fp32 train step, TF32 off, card against CPU from the same
    weights: losses rtol 1e-4, gradients within 1e-3 of each one's
    largest entry (as the CPU tests hold the port to JAX)."""
    spec = YoloSpec.create((64, 96), ((2, 3), (4, 6)), 3,
                           np.asarray(VOC_ANCHORS))
    cfg = TrainConfig(batch_size=4)
    rng = np.random.default_rng(7)
    images = torch.from_numpy(rng.uniform(0, 1, (4, 64, 96, 3)).astype(
        np.float32))
    labels = [torch.zeros((4, h, w, 3, 8)) for h, w in spec.out_hws]
    labels[1][:, 1, 2, 0, :5] = torch.tensor([0.4, 0.3, 0.2, 0.3, 1.0])
    labels[1][:, 1, 2, 0, 6] = 1.0
    states, logs = [], []
    for device in ("cpu", dev):
        net = build_network("yolo_mobilev1", spec.in_hw, 3, 3, alpha=0.25,
                            generator=torch.Generator().manual_seed(0))
        state = TT.create_train_state(net, cfg, device)
        state, lg = TT.make_train_step(spec, cfg)(
            state, images.to(device), [l.to(device) for l in labels])
        states.append(state)
        logs.append(lg)
    for k in ("loss", "l1_loss", "l2_loss"):
        np.testing.assert_allclose(float(logs[1][k]), float(logs[0][k]),
                                   rtol=1e-4, err_msg=k)
    for (name, p_cpu), p_dev in zip(states[0].net.named_parameters(),
                                    states[1].net.parameters()):
        g0, g1 = p_cpu.grad, p_dev.grad.cpu()
        scale = float(g0.abs().max())
        assert float((g1 - g0).abs().max()) <= 1e-3 * scale + 1e-12, name


def _decoded(spec, bsz, seed, dev, shift=0.0):
    preds = [torch.from_numpy(p).to(dev)
             for p in _preds(spec, bsz, seed, shift)]
    hws = torch.from_numpy(np.random.default_rng(seed).integers(
        100, 512, (bsz, 2)).astype(np.int32)).to(dev)
    return TD.decode_outputs(preds, spec, hws)


def _three_scale_spec():
    rng = np.random.default_rng(2)
    anchors = np.sort(rng.uniform(0.05, 0.9, (3, 3, 2)))[:, ::-1]
    return YoloSpec.create((224, 320), ((7, 10), (14, 20), (28, 40)), 20,
                           anchors)


@pytest.mark.parametrize("case,thresh,max_out", [
    ("sparse", 0.7, 30), ("dense", 0.7, 30), ("nan", 0.7, 30),
    ("three_scale", 0.7, 30), ("eval", 0.01, 100)])
def test_nms_kernel_matches_plain_bit_for_bit(dev, case, thresh, max_out):
    spec = _three_scale_spec() if case == "three_scale" else voc_spec()
    boxes, scores = _decoded(spec, 8, 3, dev,
                             shift=3.0 if case == "dense" else 0.0)
    if case == "nan":
        scores[0, 5, 2] = float("nan")
    before = TN.batched_nms_pallas.launches
    got = TN.batched_nms_pallas(boxes, scores, thresh, 0.45, max_out)
    torch.cuda.synchronize()
    assert TN.batched_nms_pallas.launches == before + 1
    want = TN.batched_nms_pallas_reference(boxes, scores, thresh, 0.45,
                                           max_out)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got.valid.shape == (8, spec.class_num * max_out)
    if case == "nan":
        assert not got.valid[0].reshape(spec.class_num, max_out)[2].any()
    if case in ("dense", "eval"):
        assert got.valid.any()


def test_nms_wrapper_rejects_bad_inputs(dev):
    boxes, scores = _decoded(voc_spec(), 2, 0, dev)
    kw = dict(max_out=30, iou_thresh=0.3, score_thresh=0.7)
    with pytest.raises(ValueError, match="float32"):
        TN._launch(boxes.double(), scores, **kw)
    with pytest.raises(ValueError, match="shape"):
        TN._launch(boxes[:1].contiguous(), scores, **kw)
    shifted = torch.empty(boxes.numel() + 1, device=dev)[1:].view(boxes.shape)
    with pytest.raises(ValueError, match="aligned"):
        TN._launch(shifted, scores, **kw)
    lib = TN._kernel_lib()
    for n, g in ((1, 1), (1050, 1), (1050, 2), (1050, 20), (4410, 5),
                 (11618, 1), (8937, 1), (3, 32)):
        assert lib.nms_smem_bytes(n, g) == _greedy_footprint(n, g)
    limit = TN.own_capacity(lib.nms_smem_bytes, TN._smem_limit(dev))
    assert _greedy_footprint(limit, 1) <= TN._smem_limit(dev) \
        < _greedy_footprint(limit + 1, 1)
    optin = getattr(torch.cuda.get_device_properties(dev),
                    "shared_memory_per_block_optin", None)
    if optin is not None and optin >= 232_448:
        assert limit >= 11_618
    with pytest.raises(ValueError, match="shared memory"):
        TN._launch(boxes, scores, rows=0, **kw)
    big = torch.zeros((1, limit + 1, 20), device=dev)
    # a forced G must fit shared memory; the planned path takes any N
    with pytest.raises(ValueError, match="shared memory"):
        TN._launch(torch.zeros((1, limit + 1, 4), device=dev), big, rows=1,
                   **kw)
    assert TN._plan(dev, 1, limit, 20) == ("own", 1)
    assert TN._plan(dev, 1, limit + 1, 20)[0] == "global"
    before = TN.batched_nms_pallas.global_launches
    TN._launch(torch.zeros((1, limit, 4), device=dev), big[:, :limit]
               .contiguous(), **kw)
    TN._launch(torch.zeros((1, limit + 1, 4), device=dev), big, **kw)
    torch.cuda.synchronize()
    assert TN.batched_nms_pallas.global_launches == before + 1


def _scratch_bytes(n, g, per_candidate):
    """Global scratch of one block by its definition
    (``csrc/greedy_select.cuh:scratch_floats``): n rounded up to 4, times
    the block's own floats a candidate (head 5: box and area; NMS 1: the
    area) and each row's (score, 32-bit index)."""
    return 4 * (-(-n // 4) * 4) * (per_candidate + 2 * g)


def _greedy_footprint(n, g):
    """The greedy kernels' dynamic shared memory by its definition
    (``csrc/greedy_select.cuh:smem_bytes``): one row a block keeps its
    scores and boxes, 5 floats a candidate; G rows share the boxes and
    their areas (5 floats a candidate) and each keeps a float score and a
    16-bit candidate index."""
    return 20 * n if g == 1 else n * (20 + 6 * g)


def _spec_c1():
    rng = np.random.default_rng(2)
    anchors = np.sort(rng.uniform(0.05, 0.9, (2, 3, 2)))[:, ::-1]
    return YoloSpec.create((224, 320), ((7, 10), (14, 20)), 1, anchors)


# (B, threshold, max_out, class rows a block or None for the wrapper's G);
# the inputs per case are made in _greedy_inputs
GREEDY_CASES = {
    "exit": (8, 0.7, 30, None),          # every row leaves at once
    "steps30": (8, 0.7, 30, None),       # every row runs all 30 steps
    "steps100": (4, 0.01, 100, None),    # every row runs all 100 steps
    "ties": (8, 0.7, 30, None),          # exact score ties
    "nan_row": (4, 0.7, 30, 5),          # one NaN row in a block of 5
    "thresh_-1e9": (2, -1e9, 30, None),  # suppressed candidates stay live
    "thresh_-2e9": (2, -2e9, 30, None),
    "c20_rows3": (4, 0.3, 30, 3),        # 7 blocks, one idle warp
    "c1_rows4": (4, 0.3, 30, 4),         # C=1: three idle warps
    "b1_n4410": (1, 0.3, 30, None),
    "largest_n": (1, 0.7, 30, None),
    # NaN, inf and ~1e20 box coordinates on candidates whose scores are
    # finite and above the threshold, in both layouts
    "wild_boxes_rows1": (4, 0.7, 30, 1),
    "wild_boxes_rows5": (4, 0.7, 30, 5),
}


def _greedy_inputs(case, dev, seed=6):
    """(flat logits [B, N, 5+C], geometry [8, N], lbox [B, 8], classes) for
    the head; NMS takes the same candidates decoded."""
    bsz, *_ = GREEDY_CASES[case]
    spec = {"c1_rows4": _spec_c1(), "b1_n4410": _three_scale_spec()}.get(
        case, voc_spec())
    rng = np.random.default_rng(seed)
    classes = spec.class_num
    if case == "largest_n":
        n = _own_capacity(dev)
        p = rng.normal(0, 2, (bsz, n, 5 + classes)).astype(np.float32)
        geom = np.concatenate([rng.uniform(0, 20, (2, n)),
                               rng.uniform(0.02, 0.2, (2, n)),
                               rng.uniform(0.05, 0.9, (2, n)),
                               np.ones((1, n)), np.zeros((1, n))])
        geom = torch.from_numpy(geom.astype(np.float32)).to(dev)
        hws = torch.tensor([[375, 500]], dtype=torch.int32, device=dev)
    else:
        preds = _preds(spec, bsz, seed, shift=3.0 if case == "steps30"
                       or case.startswith("wild_boxes") else 0.0)
        if case == "exit":
            preds = [np.full_like(q, -10.0) for q in preds]
        if case == "ties":
            for q in preds:
                q[..., 4:] = 2.0
        if case == "nan_row":
            preds[1][0, 3, 4, 0, 5 + 2] = np.nan   # image 0, class 2
        if case.startswith("wild_boxes"):
            for q in preds:
                q[:, 1::3, 2::3, 0, 0] = np.nan    # tx: a NaN box
                q[:, ::4, 1::4, 1, 2] = 100.0      # tw: exp overflows to inf
                q[:, 2::5, ::3, 2, 3] = 44.0       # th: ~1e20 tall, finite
                q[:, 2::5, ::6, 2, 2] = 44.0       # and wide: the area is inf
        p = np.concatenate([q.reshape(bsz, -1, 5 + classes) for q in preds],
                           1)
        geom = TH._geometry_on(spec, dev)
        hws = torch.from_numpy(rng.integers(100, 512, (bsz, 2)).astype(
            np.int32)).to(dev)
    lbox = TH.letterbox_inverse_params(hws, spec.in_hw).contiguous()
    return torch.from_numpy(p).to(dev), geom, lbox, classes


def _check_rows(case, res, classes, max_out):
    v = res.valid.reshape(-1, classes, max_out).cpu()
    if case.startswith("wild_boxes"):
        # such boxes won: the loop ran its IoU on them
        won = res.boxes[res.valid]
        assert won.isnan().any() and won.isinf().any()
        assert ((won.abs() > 1e19) & won.isfinite()).any()
    if case == "exit":
        assert not v.any()
    elif case in ("steps30", "steps100", "thresh_-1e9", "thresh_-2e9"):
        assert v.all()
    elif case == "nan_row":
        assert not v[0, 2].any() and v[0, [0, 1, 3, 4]].any(-1).all()
    else:
        assert v.any()


@pytest.mark.parametrize("layout", [None, "global", "global_loop"])
@pytest.mark.parametrize("case", sorted(GREEDY_CASES))
def test_head_kernel_greedy_cases(dev, case, layout):
    """The head kernel against its plain version (``_close``) on the cases
    the warp-per-row loop must get right, in the planned layout and on the
    global path: in score order where the threshold is above -1e9 (bit for
    bit the step loop's winners there), the step loop below; and the step
    loop on the global path, forced (``global_loop``)."""
    bsz, thresh, max_out, rows = GREEDY_CASES[case]
    p, geom, lbox, classes = _greedy_inputs(case, dev)
    kw = dict(classes=classes, max_out=max_out, iou_thresh=0.3)
    before = TH.fused_decode_nms.launches
    ordered = TH.fused_decode_nms.ordered_launches
    raw = TH._launch(p, geom, lbox, score_thresh=thresh, class_softmax=False,
                     rows=rows, layout=layout and "global",
                     ordered=False if layout == "global_loop" else None, **kw)
    got = finish_winners(*raw, thresh)
    torch.cuda.synchronize()
    assert TH.fused_decode_nms.launches == before + 1
    takes = layout == "global" and thresh > -1e9
    assert TH.fused_decode_nms.ordered_launches == ordered + int(takes)
    w_s, *w_box = TH._decode_and_select(p, geom, lbox, class_softmax=False,
                                        stop_below=thresh, **kw)
    want = finish_winners(w_s, torch.stack(w_box, dim=-1), thresh)
    _close(got, want, thresh)
    _check_rows(case, got, classes, max_out)
    if takes:
        loop = TH._launch(p, geom, lbox, score_thresh=thresh,
                          class_softmax=False, rows=rows, layout="global",
                          ordered=False, **kw)
        for g, w in zip(raw, loop):
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("layout", [None, "global"])
@pytest.mark.parametrize("case", sorted(GREEDY_CASES))
def test_nms_kernel_greedy_cases_bit_for_bit(dev, case, layout):
    """NMS alone against its plain version, bit for bit, on the same cases,
    the head's candidates decoded; at the negative thresholds most scores
    are -inf or -3e9 (suppression can raise them to -1e9)."""
    bsz, thresh, max_out, rows = GREEDY_CASES[case]
    p, geom, lbox, classes = _greedy_inputs(case, dev)
    *corners, scores = TH._decode(p, geom, lbox, classes=classes,
                                  class_softmax=False)
    boxes = torch.cat(corners, dim=1).transpose(1, 2).contiguous()
    scores = scores.transpose(1, 2).contiguous()
    if case.startswith("thresh_"):
        # 24 real candidates a row (24-47) and, before them, their boxes
        # moved by a pixel, scored -inf or -3e9; the rest -inf or -3e9.
        # Suppression raises a moved box to -1e9, and once the real ones
        # are spent the rows select those, lowest index first
        boxes[:, :24] = boxes[:, 24:48] + 1.0
        scores[:, 48:] = scores[:, :24] = -3e9
        scores[:, 48::2] = scores[:, :24:2] = -float("inf")
    before = TN.batched_nms_pallas.launches
    got = finish_winners(*TN._launch(boxes, scores, max_out=max_out,
                                     iou_thresh=0.45, score_thresh=thresh,
                                     rows=rows, layout=layout), thresh)
    torch.cuda.synchronize()
    assert TN.batched_nms_pallas.launches == before + 1
    want = TN.batched_nms_pallas_reference(boxes, scores, thresh, 0.45,
                                           max_out)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    _check_rows(case, got, classes, max_out)


def _yolo_spec_at(side):
    """The three-scale spec at side x side (N = 3 * 21 * (side / 32)^2)."""
    anchors = _three_scale_spec().anchors
    return YoloSpec.create((side, side), tuple(
        (side // st, side // st) for st in (32, 16, 8)), 20, anchors)


@pytest.mark.parametrize("what,bsz", [
    ("limit_plus_1", 2), ("yolo608", 2), ("yolo1088", 1)])
def test_greedy_kernels_take_any_candidate_count(dev, what, bsz):
    """Above the most candidates a block holds, both kernels run on the
    global path and agree with their plain versions (the head by
    ``_close``, NMS bit for bit): one more than the limit, the darknet53
    yolo at 608x608 (N=22,743) and at 1088x1088 (N=72,828, above 16-bit
    indices); scores shifted so that rows run many steps."""
    limit = _own_capacity(dev)
    rng = np.random.default_rng(11)
    if what == "limit_plus_1":
        n, spec = limit + 1, voc_spec()
        geom = torch.from_numpy(np.concatenate([
            rng.uniform(0, 20, (2, n)), rng.uniform(0.02, 0.2, (2, n)),
            rng.uniform(0.05, 0.9, (2, n)), np.ones((1, n)),
            np.zeros((1, n))]).astype(np.float32)).to(dev)
    else:
        spec = _yolo_spec_at(608 if what == "yolo608" else 1088)
        n = sum(h * w for h, w in spec.out_hws) * spec.nanchors
        geom = TH._geometry_on(spec, dev)
    assert n > limit and n == {"yolo608": 22_743, "yolo1088": 72_828}.get(
        what, n)
    p = torch.from_numpy(rng.normal(0, 2, (bsz, n, 25)).astype(np.float32))
    p[..., 4:] += 1.5
    p = p.to(dev)
    hws = torch.from_numpy(rng.integers(100, 1200, (bsz, 2)).astype(
        np.int32)).to(dev)
    lbox = TH.letterbox_inverse_params(hws, spec.in_hw).contiguous()
    kw = dict(classes=20, max_out=30, iou_thresh=0.3)
    assert TH._plan(dev, bsz, n, 20)[0] == "global"
    before = TH.fused_decode_nms.global_launches
    got = finish_winners(*TH._launch(p, geom, lbox, score_thresh=0.5,
                                     class_softmax=False, **kw), 0.5)
    torch.cuda.synchronize()
    assert TH.fused_decode_nms.global_launches == before + 1
    w_s, *w_box = TH._decode_and_select(p, geom, lbox, class_softmax=False,
                                        stop_below=0.5, **kw)
    _close(got, finish_winners(w_s, torch.stack(w_box, dim=-1), 0.5), 0.5)
    assert got.valid.reshape(bsz, 20, 30).all()

    *corners, scores = TH._decode(p, geom, lbox, classes=20,
                                  class_softmax=False)
    boxes = torch.cat(corners, dim=1).transpose(1, 2).contiguous()
    scores = scores.transpose(1, 2).contiguous()
    before = TN.batched_nms_pallas.global_launches
    got = TN.batched_nms_pallas(boxes, scores, 0.5, 0.45, 30)
    torch.cuda.synchronize()
    assert TN.batched_nms_pallas.global_launches == before + 1
    want = TN.batched_nms_pallas_reference(boxes, scores, 0.5, 0.45, 30)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    assert got.valid.any()


# (B, threshold, max_out, class_softmax) of the ordered path's cases, each
# on the global path; the inputs are made in _ordered_inputs
ORDERED_CASES = {
    "ties_and_zeros": (2, 0.0, 100, False),  # equal scores; +0 scores, kept
    "rounds": (2, 0.3, 100, False),          # 6,000 equal boxes on top
    "one_suppresses_all": (2, 0.01, 100, False),
    "nan": (4, 0.01, 100, False),            # a NaN row; a NaN image
    "wild_boxes": (4, 0.01, 100, False),     # NaN, inf, beyond +-1e18
    "below_floor": (4, 0.01, 100, False),    # corners below -1e9
    "max_out_long": (2, 0.9, 300, False),    # rows of fewer than max_out
    "limit_plus_1": (2, 0.01, 100, False),
    "softmax": (4, 0.03, 100, True),
    "eval608": (8, 0.01, 100, False),        # the eval cell's settings
    "v4_608": (4, 0.01, 100, False),         # YOLOv4's scale_x_y
    "n72828": (1, 0.01, 100, False),
}
V4_SCALE = (1.05, 1.1, 1.2)


def _ordered_inputs(case, dev, seed=12):
    """(flat logits [B, N, 25], geometry [8, N], lbox [B, 8]) of a case."""
    bsz = ORDERED_CASES[case][0]
    rng = np.random.default_rng(seed)
    if case in ("eval608", "v4_608", "nan", "wild_boxes", "softmax",
                "n72828"):
        spec = _yolo_spec_at(1088 if case == "n72828" else 608)
        if case == "v4_608":
            spec = YoloSpec.create(spec.in_hw, spec.out_hws, 20,
                                   np.asarray(spec.anchors), V4_SCALE)
        n = sum(h * w for h, w in spec.out_hws) * spec.nanchors
        geom = TH._geometry_on(spec, dev).clone()
    else:
        n = _own_capacity(dev) + 1 if case in (
            "limit_plus_1", "max_out_long", "ties_and_zeros") else 22_743
        geom = torch.from_numpy(np.concatenate([
            rng.uniform(0, 40, (2, n)), rng.uniform(0.01, 0.1, (2, n)),
            rng.uniform(0.02, 0.3, (2, n)), np.ones((1, n)),
            np.zeros((1, n))]).astype(np.float32)).to(dev)
    p = rng.normal(0, 2, (bsz, n, 25)).astype(np.float32)
    p[..., 4] -= 2.0
    if case == "ties_and_zeros":
        p[..., 4] = 2.0
        p[..., 5:] = -200.0                    # exactly +0 ...
        p[:, ::200, 5:] = 2.0                  # ... or one score
    elif case == "rounds":
        p[:, :6000, :4] = 0.5                  # 6,000 equal boxes, the
        p[:, :6000, 4:] = 6.0 + p[:, :6000, 4:] * 1e-3   # row's best
        geom[:, :6000] = geom[:, :1]
    elif case == "one_suppresses_all":
        p[..., :4] = 0.25
        geom[:] = geom[:, :1]
    elif case == "nan":
        p[0, 7, 5 + 3] = np.nan                # image 0, class 3
        p[1, 100, 4] = np.nan                  # every row of image 1
    elif case == "wild_boxes":
        p[:, 1::37, 0] = np.nan                # a NaN box
        p[:, ::41, 2] = 100.0                  # exp overflows to inf
        p[:, 2::43, 3] = 44.0                  # ~1e20 tall, finite
        p[:, 2::86, 2] = 44.0                  # and wide: the area is inf
        for wild in (np.s_[1::37], np.s_[::41], np.s_[2::43]):
            p[:, wild, 4:] += 4.0              # such boxes win
    elif case == "below_floor":
        some = rng.random(n) < 0.3
        geom[0, torch.from_numpy(some).to(dev)] = -3e10
        p[:, some, 2] = rng.uniform(0, 26, (bsz, int(some.sum())))
        p[:, some, 4:] += 3.0
    if case in ("eval608", "v4_608", "nan", "wild_boxes", "softmax",
                "n72828"):
        p[..., 4] += 1.0
        hws = rng.integers(100, 1200, (bsz, 2))
    else:
        hws = np.tile([[375, 500]], (bsz, 1))
    lbox = TH.letterbox_inverse_params(
        torch.from_numpy(hws.astype(np.int32)).to(dev),
        (608, 608)).contiguous()
    return torch.from_numpy(p).to(dev), geom, lbox


@pytest.mark.parametrize("case", sorted(ORDERED_CASES))
def test_ordered_path_equals_the_step_loop_and_plain(dev, case):
    """On the global path at a threshold above -1e9 the head selects in
    score order: one ordered launch a call; its raw winner buffers equal
    the step loop's (forced on the same path) bit for bit, and its
    detections the plain version's on the card bit for bit.  The tally of
    scan depths grows by each row's depth, at most its live candidates."""
    bsz, thresh, max_out, softmax = ORDERED_CASES[case]
    p, geom, lbox = _ordered_inputs(case, dev)
    n = p.shape[1]
    assert n > _own_capacity(dev) and TH._plan(dev, bsz, n, 20)[0] == "global"
    kw = dict(classes=20, max_out=max_out, iou_thresh=0.45,
              score_thresh=thresh, class_softmax=softmax)
    tally = TH.ordered_tally(dev)
    depth0 = int(tally.item())
    ordered = TH.fused_decode_nms.ordered_launches
    got = TH._launch(p, geom, lbox, **kw)
    torch.cuda.synchronize()
    assert TH.fused_decode_nms.ordered_launches == ordered + 1
    depth = int(tally.item()) - depth0
    loop = TH._launch(p, geom, lbox, layout="global", ordered=False, **kw)
    assert TH.fused_decode_nms.ordered_launches == ordered + 1
    for g, w in zip(got, loop):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    # the plain loop runs a stopped row on into slots below the threshold,
    # which callers mask: compare what they keep
    w_s, *w_box = TH._decode_and_select(
        p, geom, lbox, classes=20, max_out=max_out, iou_thresh=0.45,
        class_softmax=softmax, stop_below=thresh)
    want = finish_winners(w_s, torch.stack(w_box, dim=-1), thresh)
    for g, w in zip(finish_winners(*got, thresh), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    *_, scores = TH._decode(p, geom, lbox, classes=20, class_softmax=softmax)
    rows_nan = scores.isnan().any(-1)
    live = int(((scores >= thresh) & ~rows_nan[..., None]).sum())
    valid = got[0] >= thresh
    assert 0 < depth <= live
    if case == "rounds":
        # one of the 6,000 equal boxes wins, the rest are scanned past:
        # more than two rounds of 2,048 keys a row
        assert valid.all() and depth >= bsz * 20 * 6000
    elif case == "one_suppresses_all":
        assert valid.sum(-1).eq(1).all() and depth == live
    elif case == "nan":
        assert rows_nan[0, 3] and rows_nan[1].all()
        assert not valid[0, 3].any() and not valid[1].any()
        assert valid[0, [0, 1, 2, 4]].any(-1).all()
    elif case == "wild_boxes":
        won = got[1][valid]
        assert won.isnan().any() and won.isinf().any()
        assert ((won.abs() > 1e19) & won.isfinite()).any()
    elif case == "below_floor":
        assert (got[1][valid] == -1e9).any()
    elif case == "max_out_long":
        assert 0 < valid.sum(-1).max() < max_out
    elif case == "ties_and_zeros":
        assert (got[0][valid] == 0).any() and valid.all()
    else:
        assert valid.any(-1).all()


def test_serve_graph_replays_a_608_call_bit_for_bit(dev):
    """The darknet53 yolo at 608x608 (N = 22,743, the ordered path) at the
    eval settings: ``_run_batch`` captured in a CUDA graph after a warm-up
    replays two other batches bit for bit against eager calls, one ordered
    launch a call (what ``bench --mode serve_scan`` replays)."""
    spec = _yolo_spec_at(608)
    net = build_network("yolo", spec.in_hw, 3, 20,
                        generator=torch.Generator().manual_seed(0))
    pred = Predictor(net, None, spec, obj_thresh=0.01, iou_thresh=0.45,
                     max_out=100, compute_dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(8)

    def batch():
        c = rng.integers(0, 256, (2, 512, 512, 3)).astype(np.uint8)
        h = np.stack([rng.integers(300, 513, 2), rng.integers(300, 513, 2)],
                     -1).astype(np.int32)
        return torch.from_numpy(c).to(dev), torch.from_numpy(h).to(dev)

    static_c, static_h = batch()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    ordered = TH.fused_decode_nms.ordered_launches
    with torch.cuda.stream(side):
        pred._run_batch(static_c, static_h)
    torch.cuda.current_stream(dev).wait_stream(side)
    assert TH.fused_decode_nms.ordered_launches == ordered + 1
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = pred._run_batch(static_c, static_h)
    for _ in range(2):
        c, h = batch()
        static_c.copy_(c)
        static_h.copy_(h)
        graph.replay()
        want = pred._run_batch(c, h)
        assert int(want.valid.sum()) > 0
        for field, got, ref in zip(want._fields, captured, want):
            assert torch.equal(got, ref), field


def test_scratch_footprints_follow_their_definition(dev):
    for n, g in ((1, 1), (1050, 20), (11623, 1), (22743, 2), (72828, 32)):
        assert TH._kernel_lib().yolo_head_scratch_bytes(n, g) == \
            _scratch_bytes(n, g, 5)
        assert TN._kernel_lib().nms_scratch_bytes(n, g) == \
            _scratch_bytes(n, g, 1)


def _dwsep_args(shape, dtype, dev, seed=8):
    b, h, w, c, cout = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1, (b, h, w, c)).astype(
        np.float32)).to(dev).to(dtype)
    args = [torch.from_numpy(a).to(dev) for a in (
        rng.normal(0, 0.3, (3, 3, c)), rng.uniform(0.5, 1.5, c),
        rng.normal(0, 0.2, c), rng.normal(0, 0.1, (c, cout)),
        rng.uniform(0.5, 1.5, cout), rng.normal(0, 0.2, cout))]
    return x, [a.to(torch.float32) for a in args]


@pytest.mark.parametrize("shape,dtype", [
    ((1, 9, 13, 16, 24), torch.float32), ((1, 9, 13, 16, 24), torch.bfloat16),
    ((8, 14, 20, 384, 384), torch.bfloat16),
    ((2, 7, 10, 768, 768), torch.bfloat16),
    ((2, 7, 10, 576, 576), torch.float32),
    ((2, 112, 160, 24, 48), torch.bfloat16),
    ((1, 9, 13, 20, 36), torch.bfloat16), ((1, 9, 13, 20, 36), torch.float32),
    ((3, 5, 7, 96, 96), torch.bfloat16), ((3, 5, 7, 768, 768), torch.bfloat16)])
def test_dwsep_kernel_matches_plain(dev, shape, dtype):
    """The odd 9x13 shape; served blocks' shapes at a small batch (block_7,
    block_13, and block_1 at its full 112x160); a wide fp32 one; ragged C
    and Cout (20 -> 36: K padded to 32, a part-filled n8 tile, no 16-byte
    access); 105 pixels, not a multiple of the 64-pixel tile."""
    b, h, w, c, cout = shape
    x, args = _dwsep_args(shape, dtype, dev)
    before = TF.fused_dwsep.launches
    got = TF.fused_dwsep(x, *args)
    torch.cuda.synchronize()
    assert TF.fused_dwsep.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, h, w, cout)
    want = TF.fused_dwsep_reference(x, *args)
    tol = 2e-5 if dtype == torch.float32 else 0.05
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,cout", [(24, 48), (20, 36)])
def test_dwsep_kernel_nan_positions_match_plain(dev, c, cout, dtype):
    """A NaN in x makes NaN of the 3x3 neighbourhood's pixels, every output
    channel, in both versions; the rest within tolerance."""
    x, args = _dwsep_args((2, 9, 13, c, cout), dtype, dev)
    x[0, 4, 6, 3] = float("nan")
    x[1, 0, 0, c - 1] = float("nan")      # a corner, the last channel
    got = TF.fused_dwsep(x, *args).float().cpu()
    want = TF.fused_dwsep_reference(x, *args).float().cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert int(torch.isnan(got).sum()) == (9 + 4) * cout
    tol = 2e-5 if dtype == torch.float32 else 0.05
    ok = ~torch.isnan(want)
    np.testing.assert_allclose(got[ok].numpy(), want[ok].numpy(), rtol=tol,
                               atol=tol)


def _dwsep_footprint(is_bf16, c):
    """The kernel's dynamic shared memory by its definition: bf16, a
    64-pixel A tile of K = C rounded up to 16 plus 8 pad columns and a ring
    of three 32 x (64 + 8) chunks of pw_k; fp32, the 64 x C tile."""
    if is_bf16:
        return 2 * (64 * ((c + 15) // 16 * 16 + 8) + 3 * 32 * 72)
    return 4 * 64 * c


def test_dwsep_wrapper_rejects_bad_inputs(dev):
    x = torch.zeros((1, 4, 5, 8), device=dev)
    args = [torch.zeros(s, device=dev) for s in ((3, 3, 8), (8,), (8,),
                                                 (8, 6), (6,), (6,))]
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        TF._launch(x.half(), *args, 0.3)
    with pytest.raises(ValueError, match="pw_k"):
        TF._launch(x, *args[:3], args[3][:4], *args[4:], 0.3)
    with pytest.raises(ValueError, match="x:"):
        TF._launch(x.transpose(1, 2).contiguous().transpose(1, 2), *args,
                   0.3)
    lib = TF._kernel_lib()
    for dtype in (torch.float32, torch.bfloat16):
        is_bf16 = dtype == torch.bfloat16
        for c in (1, 20, 24, 384, 768, 1000):
            assert lib.dwsep_smem_bytes(int(is_bf16), c) == \
                _dwsep_footprint(is_bf16, c)
        limit = TF._max_channels(dev, is_bf16)
        optin = getattr(torch.cuda.get_device_properties(dev),
                        "shared_memory_per_block_optin", None)
        if optin is not None:
            assert _dwsep_footprint(is_bf16, limit) <= optin
        if is_bf16:
            assert limit >= 768           # the widest served block
        f32 = [torch.zeros(s, device=dev) for s in ((3, 3, limit + 1),
                                                     (limit + 1,),
                                                     (limit + 1,))]
        wide = torch.zeros((1, 2, 2, limit + 1), device=dev, dtype=dtype)
        pw = torch.zeros((limit + 1, 6), device=dev, dtype=dtype)
        with pytest.raises(ValueError, match="shared memory"):
            TF._launch(wide, *f32, pw, *args[4:], 0.3)
        # the widest accepted tile launches
        TF._launch(wide[..., :limit].contiguous(),
                   *(t[..., :limit].contiguous() for t in f32),
                   pw[:limit].contiguous(), *args[4:], 0.3)
        torch.cuda.synchronize()


def test_build_rebuilds_when_only_the_header_changes(dev, tmp_path,
                                                     monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first, log = _build.build("nms")
    assert first.exists() and "nms_kernel" in log
    again, log = _build.build("nms")
    assert again == first and log == ""          # unchanged: loaded as built
    header = csrc / "greedy_select.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    rebuilt, log = _build.build("nms")
    assert rebuilt != first and rebuilt.exists() and "nms_kernel" in log


# ---- pruning and the overfit chain -----------------------------------------

def test_pruned_train_step_on_card_matches_cpu(dev):
    """Two pruned fp32 steps (masks updated after each) on the smooth
    witness, card against CPU from the same weights: losses and sparsity
    rtol 1e-4; masks equal, except where the updated weight lies within
    1e-6 of its kernel's threshold (counted; none expected).  From the same
    weights ``update_masks`` agrees exactly."""
    from k210_yolo_framework_tpu_torch.training import pruning as P

    spec = _builder_spec(2, (96, 128), classes=3)
    cfg = TrainConfig(batch_size=2, is_prune=True, prune_frequency=1,
                      prune_end_epoch=1)
    rng = np.random.default_rng(8)
    images = torch.from_numpy(rng.uniform(0, 1, (2, 96, 128, 3)).astype(
        np.float32))
    labels = [torch.zeros((2, h, w, 3, 8)) for h, w in spec.out_hws]
    labels[-1][:, 1, 2, 0, :5] = torch.tensor([0.4, 0.3, 0.2, 0.3, 1.0])
    labels[-1][:, 1, 2, 0, 6] = 1.0
    states, logs = [], []
    for device in ("cpu", dev):
        net = smooth_witness(build_network(
            "yolo_mobilev1", spec.in_hw, 3, 3, alpha=0.5,
            generator=torch.Generator().manual_seed(0)))
        state = TT.create_train_state(net, cfg, device)
        step = TT.make_train_step(spec, cfg, train_epoch_step=2)
        lg = []
        for _ in range(2):
            state, out = step(state, images.to(device),
                              [l.to(device) for l in labels])
            lg.append({k: float(v) for k, v in out.items()})
        states.append(state)
        logs.append(lg)
    for a, b in zip(*logs):
        for k in ("loss", "l1_loss", "l2_loss", "sparsity"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-4, err_msg=k)
    cpu, card = states
    params = {n: p.detach().cpu() for n, p in cpu.net.named_parameters()}
    near = 0
    for n, m in cpu.masks.items():
        diff = card.masks[n].cpu() != m
        if diff.any():
            thr = P._thresholds([torch.sort(
                params[n].abs().reshape(-1)).values],
                P.polynomial_sparsity(1, 0.5, 0.9, 0, 2))
            w = params[n].abs()[diff]
            assert ((w - thr).abs() <= 1e-6 * thr).all(), n
            near += int(diff.sum())
    assert near <= 2
    same = {n: params[n].to(dev) for n in cpu.masks}
    got = P.update_masks(same, cpu.masks, 0.7)
    want = P.update_masks(params, cpu.masks, 0.7)
    for n in want:
        assert torch.equal(got[n].cpu(), want[n]), n
    assert abs(float(P.sparsity_of(got)) - float(P.sparsity_of(want))) == 0


def test_overfit_recalibrate_npz_map_on_card(dev, tmp_path):
    """The JAX package's end-to-end chain (``tests/test_end_to_end.py``) on
    the card: overfit 6 images for 250 steps, recalibrate the BN
    statistics, save and load the weights through ``.npz``, and score VOC
    mAP above the JAX test's pinned floor of 0.8."""
    from k210_yolo_framework_tpu_torch.data import pipeline as PL
    from k210_yolo_framework_tpu_torch.eval import evaluate_map
    from k210_yolo_framework_tpu_torch.training import checkpoint as TC

    n_img, classes = 6, 4
    ann = PL.synthetic_ann_list(str(tmp_path), n=n_img, class_num=classes,
                                seed=5)
    anchors = np.array([[[0.7, 0.6], [0.5, 0.5], [0.4, 0.3]],
                        [[0.3, 0.3], [0.2, 0.2], [0.15, 0.15]]], np.float32)
    spec = YoloSpec.create((96, 96), ((3, 3), (6, 6)), classes, anchors)
    cfg = TrainConfig(batch_size=n_img, obj_thresh=0.7, iou_thresh=0.5,
                      init_learning_rate=2e-3)
    net = build_network("yolo_mobilev1", spec.in_hw, spec.nanchors,
                        spec.class_num, alpha=0.5)
    pipe = PL.DataPipeline(ann, n_img, seed=1, use_native=False,
                           canvas_hw=(512, 512))
    pp = PL.make_preprocess_fn(spec, is_training=False)
    state = TT.create_train_state(net, cfg, dev)
    step = TT.make_train_step(spec, cfg, train_epoch_step=1)
    with torch.no_grad():
        images, labels = pp(*next(iter(pipe)).to(dev))
    losses = []
    for _ in range(250):
        state, logs = step(state, images, labels)
        losses.append(logs["loss"])
    first, last = float(losses[0]), float(losses[-1])
    assert last < first * 0.2, f"did not overfit: {first} -> {last}"
    TT.recalibrate_batch_stats(net, iter(pipe), pp, num_batches=4,
                               device=dev)
    TC.save_npz(str(tmp_path / "m.npz"), net)
    fresh = build_network("yolo_mobilev1", spec.in_hw, spec.nanchors,
                          spec.class_num, alpha=0.5)
    sd = TC.load_variables(str(tmp_path / "m.npz"), "yolo_mobilev1", fresh)
    for k, v in net.state_dict().items():
        assert torch.equal(sd[k], v.cpu()), k
    pred = Predictor(fresh, sd, spec, obj_thresh=0.1, iou_thresh=0.45,
                     max_out=20, device=dev)
    res = evaluate_map(pred, ann, classes, batch_size=n_img)
    print(f"mAP after overfit + recalibrate on the card: {res['map']:.4f}")
    assert res["map"] > 0.8, res["map"]


# ---- quantized serving and the exported program ----------------------------

def _int8_scene(bsz=4):
    rng = np.random.default_rng(6)
    canvases = rng.integers(0, 256, (bsz, 240, 320, 3)).astype(np.uint8)
    hws = np.tile(np.array([[240, 320], [200, 300], [240, 100], [120, 320]],
                           np.int32), (bsz // 4, 1))
    return canvases, hws


@pytest.mark.parametrize("m,k,n", [(70, 768, 192), (8960, 384, 384),
                                   (1120, 4608, 128)])
def test_int_mm_card_equals_cpu(dev, m, k, n):
    """The int8 product of the int8 conv (cuBLASLt IMMA on the card) is
    exact int32, as on the CPU, at the served shapes."""
    rng = np.random.default_rng(m)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8)).t()
    want = torch._int_mm(a, b)
    got = torch._int_mm(a.to(dev), b.to(dev)).cpu()
    assert torch.equal(got, want)
    assert torch.equal(want, (a.long() @ b.long()).int())


@pytest.mark.parametrize("cin,cout,hw,kernel", [
    (12, 16, (4, 4), (1, 1)),     # 16 rows
    (12, 20, (5, 5), (1, 1)),     # k and n not multiples of 8
    (124, 124, (3, 4), (1, 1)),   # yolo_mobilev2's widths, 12 rows
    (16, 24, (5, 7), (3, 3)),     # a shape _int_mm takes as it is
    (20, 12, (3, 3), (3, 3))])
def test_int8_conv_pads_shapes_int_mm_cannot_take(dev, cin, cout, hw,
                                                  kernel):
    """A shape that torch._int_mm on CUDA refuses (16 rows or fewer, k or
    n not a multiple of 8) is zero padded: the card's int8 conv equals the
    CPU's bit for bit (the same IEEE quantize arithmetic, an exact int32
    product)."""
    from k210_yolo_framework_tpu_torch.models.layers import Conv, Int8Act

    pads = tuple(((k - 1) // 2, k // 2) for k in kernel)
    conv = Conv(cin, cout, kernel, pads=pads)
    torch.nn.init.normal_(conv.weight)
    x = torch.rand(1, cin, *hw) - 0.2
    for act in (Int8Act(torch.float32), Int8Act(torch.float32, False)):
        want = conv.forward_int8(x, act)
        got = copy.deepcopy(conv).to(dev).forward_int8(x.to(dev), act)
        assert torch.equal(got.cpu(), want)


def test_v2_int8_act_on_card_matches_cpu(dev):
    """yolo_mobilev2 alpha 0.75 serves int8_act on the card: its
    124-channel convs go through the zero-padded product, each int8 conv
    equals the CPU's bit for bit on the card's input, and the head kernel
    runs once a call."""
    from k210_yolo_framework_tpu_torch.models.layers import Conv

    spec = voc_spec()
    net = build_network("yolo_mobilev2", spec.in_hw, 3, 20, alpha=0.75,
                        generator=torch.Generator().manual_seed(0))
    canvases, hws = _int8_scene()
    convs = []
    real = Conv.forward_int8

    def capture(self, x, act):
        y = real(self, x, act)
        convs.append((self, x, act, y))
        return y

    pred = Predictor(net, None, spec, obj_thresh=0.2, quantize="int8_act",
                     device=dev)
    before = TH.fused_decode_nms.launches
    Conv.forward_int8 = capture
    try:
        dets = pred.predict_batch(canvases, hws)
    finally:
        Conv.forward_int8 = real
    assert TH.fused_decode_nms.launches == before + 1
    assert all(np.isfinite(d.scores).all() for d in dets)
    assert any(conv.weight.shape[0] % 8 for conv, *_ in convs)
    for conv, x, act, y in convs:
        want = real(copy.deepcopy(conv).cpu(), x.cpu(), act)
        assert torch.equal(y.cpu(), want), conv.scope


@pytest.mark.parametrize("mode", ["int8", "int8_act", "int8_act_sym",
                                  "int8_act_cal"])
def test_quantized_predictor_on_card_matches_cpu(dev, mode):
    """yolo_mobilev1 alpha 0.75 (every dense conv's k and n multiples of
    8), B=4 fp32, TF32 off, one head launch a call.  int8: the kernels are
    int8 on the card and the detections are the CPU's at set level.  The
    int8-activation modes: an ulp between cuDNN's and the CPU's fp32 convs
    flips an activation rounding now and then (one quantum each), which
    the later layers carry; so each int8 conv is held to the CPU bit for
    bit on the input the card's forward gave it."""
    from k210_yolo_framework_tpu_torch.inference import stack_detections
    from k210_yolo_framework_tpu_torch.models.layers import Conv
    from k210_yolo_framework_tpu_torch.utils.detmatch import (
        assert_detections_close,
    )

    spec = voc_spec()
    net = build_network("yolo_mobilev1", spec.in_hw, 3, 20, alpha=0.75,
                        generator=torch.Generator().manual_seed(0))
    canvases, hws = _int8_scene()
    dets, convs = [], []
    real = Conv.forward_int8

    def capture(self, x, act):
        y = real(self, x, act)
        if x.is_cuda:
            convs.append((self, x, act, y))
        return y

    for device in ("cpu", dev):
        pred = Predictor(net, None, spec, obj_thresh=0.2, quantize=mode,
                         device=device)
        if mode == "int8_act_cal":
            pred.calibrate(canvases, hws)
        before = TH.fused_decode_nms.launches
        Conv.forward_int8 = capture
        try:
            dets.append(stack_detections(pred.predict_batch(canvases, hws)))
        finally:
            Conv.forward_int8 = real
        if device != "cpu":
            assert TH.fused_decode_nms.launches == before + 1
    if mode == "int8":
        assert all(v.q.is_cuda and v.q.dtype == torch.int8
                   for v in pred.qweights.values())
        n_cpu, _ = assert_detections_close(dets[1], dets[0])
        assert n_cpu > 0 and not convs
        return
    assert len(convs) == 16
    for conv, x, act, y in convs:
        want = real(copy.deepcopy(conv).cpu(), x.cpu(), act)
        assert torch.equal(y.cpu(), want), conv.scope


def test_exported_serving_program_on_card(dev, tmp_path):
    """export_serving of a bf16 and an int8 card Predictor: saved, loaded
    and run on the card, each equals its eager program there and the live
    Predictor at set level (the program runs the live forward; its NMS is
    the plain one, which phase 11 of chip_smoke.py holds to the kernel)."""
    from k210_yolo_framework_tpu_torch.export import (
        ServingProgram,
        export_serving,
    )
    from k210_yolo_framework_tpu_torch.inference import stack_detections
    from k210_yolo_framework_tpu_torch.ops.nms import NmsResult
    from k210_yolo_framework_tpu_torch.utils.detmatch import (
        assert_detections_close,
    )

    spec = voc_spec()
    net = build_network("yolo_mobilev1", spec.in_hw, 3, 20, alpha=0.75,
                        generator=torch.Generator().manual_seed(0))
    canvases, hws = _int8_scene()
    c = torch.from_numpy(canvases).to(dev)
    h = torch.from_numpy(hws).to(dev)
    for mode, dtype in ((None, torch.bfloat16), ("int8", torch.bfloat16)):
        pred = Predictor(net, None, spec, obj_thresh=0.2, quantize=mode,
                         compute_dtype=dtype, device=dev)
        path = tmp_path / f"{mode}.pt2"
        torch.export.save(export_serving(pred, batch=4,
                                         canvas_hw=(240, 320)), path)
        got = torch.export.load(path).module()(c, h)
        with torch.inference_mode():
            want = ServingProgram(pred)(c, h)
        for a, b in zip(got, want):
            assert a.is_cuda and torch.equal(a, b)
        live = stack_detections(pred.predict_batch(canvases, hws))
        n, _ = assert_detections_close(
            NmsResult(*(t.cpu().numpy() for t in got)), live)
        assert n > 0


def test_mesh_fused_step_over_nccl_equals_the_plain_step(dev, tmp_path):
    """The sharded fused step over a world-size-1 NCCL group (augment on:
    the rotation kernel) against the plain fused step, 2 steps from the
    same weights and draws, cuDNN deterministic: parameters, BN
    statistics, Adam state and logs bit for bit, one rotation launch a
    step."""
    import torch.distributed as dist

    from k210_yolo_framework_tpu_torch.data.pipeline import (
        HostBatch,
        make_preprocess_fn,
    )
    from k210_yolo_framework_tpu_torch.ops.codec import pad_boxes
    from k210_yolo_framework_tpu_torch.parallel import init_world, make_mesh

    spec = YoloSpec.create((64, 96), ((2, 3), (4, 6)), 3,
                           np.asarray(VOC_ANCHORS))
    cfg = TrainConfig(batch_size=6, augment=True)
    rng = np.random.default_rng(8)
    hws = np.array([[80, 120], [64, 96], [40, 120]] * 2, np.int32)
    canvases = rng.integers(0, 256, (6, 80, 120, 3)).astype(np.uint8)
    boxes, valid = zip(*(pad_boxes(np.array([[1, 0.5, 0.5, 0.3, 0.4]]))
                         for _ in range(6)))
    host = HostBatch(canvases, hws, np.stack(boxes).astype(np.float32),
                     np.stack(valid))
    gen = torch.Generator().manual_seed(4)
    draws = [TA.draw_params(6, spec.in_hw, generator=gen) for _ in range(2)]
    pp = make_preprocess_fn(spec, True)
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        def train(mesh):
            net = build_network("yolo_mobilev1", spec.in_hw, 3, 3,
                                alpha=0.25,
                                generator=torch.Generator().manual_seed(0))
            state = TT.create_train_state(net, cfg, dev)
            if mesh is not None:
                TT.shard_state(state, mesh)
            step = TT.make_fused_train_step(spec, cfg, pp, mesh=mesh)
            batch = host if mesh is not None else host.to(dev)
            logs = []
            for p in draws:
                state, lg = step(state, *batch, params=p)
                logs.append({k: float(v) for k, v in lg.items()})
            return state, logs

        plain, plain_logs = train(None)
        init_world(dev, f"file://{tmp_path}/init", 0, 1)
        try:
            TR.rotate_3shear.launches = 0
            meshed, mesh_logs = train(make_mesh())
            assert TR.rotate_3shear.launches == 2
        finally:
            dist.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            flags
    assert mesh_logs == plain_logs
    for (name, a), b in zip(plain.net.state_dict().items(),
                            meshed.net.state_dict().values()):
        assert torch.equal(a, b), name
    for p, q in zip(plain.net.parameters(), meshed.net.parameters()):
        sa, sb = plain.optimizer.state[p], meshed.optimizer.state[q]
        assert sorted(sa) == sorted(sb)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k


def test_halo_and_gather_on_cuda_tensors_over_gloo(dev, tmp_path):
    """The model and space axes' collectives on CUDA tensors: four
    processes share the card (NCCL refuses two ranks on one card), joined
    by gloo, on a (1, 2, 2) mesh.  Each rank's rows with their one-row
    halos equal those rows of the zero-padded whole and the gathered
    channels the whole tensor, exactly; the backward of sum(out * g) gives
    each row the sum of the gradients of every window it lies in, and each
    channel slice its gradient summed over the model group (2 g)."""
    import torch_tpsp_worker as W
    from torch_parallel_worker import spawn_world

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 6, 5)).astype(np.float32)
    g = rng.standard_normal((2, 4, 6, 5)).astype(np.float32)
    seen = spawn_world(4, dict(coll_x=x, coll_g=g), tmp_path,
                       target=W.cuda_collectives)
    padded = np.pad(x, ((0, 0), (0, 0), (1, 1), (0, 0)))
    windows = np.zeros_like(g)
    for s in seen:
        lo, hi = s["rows"]
        windows[:, :, max(lo - 1, 0):min(hi + 1, 6)] += \
            g[:, :, max(lo - 1, 0):min(hi + 1, 6)] / 2
    assert sorted({s["rows"] for s in seen}) == [(0, 3), (3, 6)]
    for s in seen:
        lo, hi = s["rows"]
        clo, chi = s["channels"]
        np.testing.assert_array_equal(s["halo"], padded[:, :, lo:hi + 2])
        np.testing.assert_allclose(s["halo_grad"], windows[:, :, lo:hi],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(s["gathered"], x)
        np.testing.assert_allclose(s["gather_grad"], 2 * g[:, clo:chi],
                                   rtol=1e-6, atol=1e-6)


def test_pooled_halo_on_cuda_tensors_over_gloo(dev, tmp_path):
    """tiny_yolo's SAME max-pools (and their log-sum-exp witness) on a
    (1, 2, 2) mesh of four processes sharing the card, joined by gloo, on
    CUDA tensors: a split input's stride-1 pool takes one row of the next
    space rank, -inf past the last; a stride-2 pool of an odd number of
    output rows gathers; forward and backward equal the whole pool's
    (``torch_tpsp_worker.assert_pools_whole``, on the CPU)."""
    import torch_tpsp_worker as W
    from torch_parallel_worker import spawn_world

    rng = np.random.default_rng(5)
    job = dict(pool_x=-(np.abs(rng.standard_normal((2, 3, 8, 5))) + 0.5)
               .astype(np.float32),
               pool_g=rng.standard_normal((2, 3, 8, 5)).astype(np.float32))
    seen = spawn_world(4, job, tmp_path, target=W.cuda_pools)
    for case in W.POOL_CASES:
        for pool in W.POOLS:
            W.assert_pools_whole(seen, job, case, pool)


def test_keras_train_mesh_needs_one_card_a_rank(dev):
    """--mesh 1,2 on a one-card machine exits before any rank starts:
    nothing falls back to gloo or to the CPU."""
    from k210_yolo_framework_tpu_torch.cli import keras_train as KT

    if torch.cuda.device_count() != 1:
        pytest.skip("the refusal is a one-card machine's")
    with pytest.raises(SystemExit,
                       match="2 processes, one a card, but 1 visible"):
        KT.main(KT.parse_args(["--model_def", "yolo_mobilev1",
                               "--mesh", "1,2"]))


# the epilogue's (x dtype, store) pairs, and shapes [B, C, H, W] with their
# memory format: 8 channels a thread (C % 8 == 0, channels last) and the
# scalar path (C = 20, or NCHW), pixel counts that are no multiple of a
# block among them
EPILOGUE_TYPES = [(torch.float32, torch.float32),
                  (torch.bfloat16, torch.float32),
                  (torch.bfloat16, torch.bfloat16)]
EPILOGUE_SHAPES = [((3, 24, 7, 10), torch.channels_last),
                   ((1, 768, 7, 10), torch.channels_last),
                   ((2, 20, 5, 7), torch.channels_last),
                   ((2, 6, 8, 16), torch.contiguous_format),
                   ((3, 5, 3, 5), torch.contiguous_format),
                   ((2, 128, 57, 77), torch.channels_last)]


def _epilogue_case(shape, fmt, dtype, dev, seed):
    """x with NaN, +-inf, -0, +0 and 6.0 planted, and per-channel terms
    whose channel 0 is the identity with a -0 shift, so a -0 input comes
    out of the BN as -0 and 6.0 as 6.0; a residual with the same
    specials; a per-image scale."""
    g = torch.Generator().manual_seed(seed)
    b, c, h, w = shape
    x = torch.randn(shape, generator=g) * 3
    flat = x.view(-1)
    special = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0,
                            0.0, 6.0, -1e-40, 1e-40])
    idx = torch.randint(0, flat.numel(), (64,), generator=g)
    flat[idx] = special[torch.arange(64) % len(special)]
    x[:, 0] = special[torch.arange(h * w) % len(special)].view(h, w)
    mean = torch.randn(c, generator=g) * 0.5
    mul = torch.rand(c, generator=g) + 0.5
    bias = torch.randn(c, generator=g) * 0.5
    mean[0], mul[0], bias[0] = 0.0, 1.0, -0.0
    res = torch.randn(shape, generator=g)
    res.view(-1)[idx.flip(0)] = special[torch.arange(64) % len(special)]
    scale = torch.rand(b, generator=g) + 0.5
    to = dict(device=dev, memory_format=fmt)
    return (x.to(dtype=dtype, **to), mean.to(dev), mul.to(dev), bias.to(dev),
            scale.to(dev), res.to(**to))


def _bits(t):
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


@pytest.mark.parametrize("act", ["none", "relu", "relu6", "leaky_relu"])
@pytest.mark.parametrize("dtype,store", EPILOGUE_TYPES)
def test_conv_epilogue_kernel_matches_plain_bit_for_bit(dev, dtype, store,
                                                        act):
    """The kernel against its plain version on the card, bit for bit, on
    every layout path, with and without the scale and the residual: NaN,
    +-inf, -0 and the ReLU6 bound included.  One launch a call, and the
    output keeps x's strides."""
    from k210_yolo_framework_tpu_torch.ops import conv_epilogue as TE

    for k, (shape, fmt) in enumerate(EPILOGUE_SHAPES + [(None, None)]):
        if shape is None:   # channels last, 2 bytes off 16: the scalar path
            shape, fmt = EPILOGUE_SHAPES[0]
            x, mean, mul, bias, scale, res = _epilogue_case(shape, fmt, dtype,
                                                            dev, seed=k)
            b, c, h, w = shape
            off = torch.empty(x.numel() + 1, dtype=dtype, device=dev)[1:]
            x = off.view(b, h, w, c).permute(0, 3, 1, 2).copy_(x)
            assert x.is_contiguous(memory_format=fmt)
        else:
            x, mean, mul, bias, scale, res = _epilogue_case(shape, fmt, dtype,
                                                            dev, seed=k)
        for s in (None, scale):
            for r in (None, res):
                kw = dict(act=act, alpha=0.1, scale=s, residual=r,
                          store=store)
                before = TE.conv_epilogue.launches
                got = TE.conv_epilogue(x, mean, mul, bias, **kw)
                assert TE.conv_epilogue.launches == before + 1
                want = TE.conv_epilogue_reference(x, mean, mul, bias, **kw)
                torch.cuda.synchronize()
                assert got.dtype == want.dtype == store
                assert got.stride() == x.stride()
                assert torch.equal(_bits(got), _bits(want)), (
                    shape, fmt, s is not None, r is not None)


def test_conv_epilogue_wrapper_rejects_bad_inputs(dev):
    from k210_yolo_framework_tpu_torch.ops import conv_epilogue as TE

    x, mean, mul, bias, scale, res = _epilogue_case(
        (2, 16, 4, 4), torch.channels_last, torch.bfloat16, dev, seed=0)
    with pytest.raises(ValueError, match="store"):
        TE.conv_epilogue(x, mean, mul, bias, store=torch.float16)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        TE.conv_epilogue(x.half(), mean, mul, bias)
    with pytest.raises(ValueError, match="mean"):
        TE.conv_epilogue(x, mean[:8], mul, bias)
    with pytest.raises(ValueError, match="dense"):
        TE.conv_epilogue(x[:, :, :, :2], mean, mul, bias)
    with pytest.raises(ValueError, match="residual"):
        TE.conv_epilogue(x, mean, mul, bias, residual=res[:1])
    with pytest.raises(ValueError, match="act"):
        TE.conv_epilogue(x, mean, mul, bias, act="gelu")


def _random_bn(net, seed):
    """BatchNorm statistics and affine terms drawn, so that no BN is the
    identity."""
    from k210_yolo_framework_tpu_torch.models.layers import BatchNorm

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(0.0, 0.3, generator=g)
                m.running_var.uniform_(0.3, 2.0, generator=g)
                m.weight.uniform_(0.4, 0.6, generator=g)
                m.bias.normal_(0.3, 0.3, generator=g)
    return net


# (builder, alpha, output layers, ConvBNs): yolo_mobilev1 at the served
# alpha and the darknet53 yolo name their counts
EPILOGUE_BUILDERS = [("yolo_mobilev1", 0.75, 2, 30), ("yolo_mobilev2", 0.75,
                                                      2, None),
                     ("tiny_yolo", 1.0, 2, None), ("yolo", 1.0, 3, 72)]


@pytest.mark.parametrize("name,alpha,layers,convbns", EPILOGUE_BUILDERS)
def test_builder_served_through_the_epilogue_bit_for_bit(dev, name, alpha,
                                                         layers, convbns):
    """Each builder served on the card in bf16: one epilogue launch per
    ConvBN a call, and the logits equal the plain path's bit for bit (the
    same forward with gradients on, where every ConvBN runs BatchNorm, the
    activation and the residual add as their own passes)."""
    from k210_yolo_framework_tpu_torch.inference import folded_logits
    from k210_yolo_framework_tpu_torch.models.layers import ConvBN
    from k210_yolo_framework_tpu_torch.ops import conv_epilogue as TE

    spec = _builder_spec(layers)
    net = _random_bn(build_network(name, spec.in_hw, 3, 20, alpha=alpha,
                                   generator=torch.Generator().manual_seed(0)),
                     seed=3)
    n = sum(isinstance(m, ConvBN) for m in net.modules())
    assert convbns is None or n == convbns
    pred = Predictor(net, None, spec, obj_thresh=0.2,
                     compute_dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(4)
    canvases = rng.integers(0, 256, (4, 240, 320, 3)).astype(np.uint8)
    hws = np.array([[240, 320], [200, 300], [240, 100], [120, 320]], np.int32)
    before = TE.conv_epilogue.launches
    pred.predict_batch(canvases, hws)
    assert TE.conv_epilogue.launches == before + n
    c = torch.from_numpy(canvases).to(dev)
    h = torch.from_numpy(hws).to(dev)
    fused = pred._forward_batch(c, h)
    imgs = pred._letterbox_for_stem(c, h, pred.compute_dtype)
    with torch.enable_grad():
        plain = folded_logits(pred.net, pred._materialize(), imgs,
                              pred.module_dtype)
    assert TE.conv_epilogue.launches == before + 2 * n
    for f, p in zip(fused, plain):
        assert torch.equal(_bits(f), _bits(p))


def test_epilogue_not_launched_in_training_sharded_or_export(dev):
    """A train step, a forward on the TP/SP path (one rank's Sharded
    activations) and torch.export's trace launch no epilogue."""
    import types

    from k210_yolo_framework_tpu_torch.export import export_raw
    from k210_yolo_framework_tpu_torch.ops import conv_epilogue as TE

    spec = voc_spec()
    net = build_network("yolo_mobilev1", spec.in_hw, 3, 20, alpha=0.75,
                        generator=torch.Generator().manual_seed(0))
    before = TE.conv_epilogue.launches
    cfg = TrainConfig(batch_size=2)
    state = TT.create_train_state(net, cfg, dev)
    images = torch.rand((2, *spec.in_hw, 3), device=dev)
    labels = [torch.zeros((2, h, w, 3, 25), device=dev)
              for h, w in spec.out_hws]
    TT.make_train_step(spec, cfg)(state, images, labels)
    one_rank = types.SimpleNamespace(
        dp=1, mp=1, sp=1, model_group=None, space_group=None,
        data_group=None, pixel_group=None, batch_group=lambda rows: None,
        channel_range=lambda c: (0, c), row_range=lambda h: (0, h))
    served = copy.deepcopy(net).to(dev).eval()
    with torch.inference_mode():
        sharded = served(images, dtype=torch.bfloat16, shard=one_rank)
        whole = served(images, dtype=torch.bfloat16)
    assert TE.conv_epilogue.launches == before + 30
    assert [a.shape for a in sharded] == [b.shape for b in whole]
    export_raw(net, None, 1, device=dev)
    torch.cuda.synchronize()
    assert TE.conv_epilogue.launches == before + 30

"""The port's CUDA head kernel against its plain PyTorch version, on a GPU.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports nothing of JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances are those of ``tests/test_yolo_head_pallas.py``; ``valid`` may
differ only where a score lies within 1e-5 of the threshold.
"""

import numpy as np
import pytest
import torch

from k210_yolo_framework_tpu_torch.config import YoloSpec, voc_spec
from k210_yolo_framework_tpu_torch.inference import Predictor
from k210_yolo_framework_tpu_torch.models import build_network
from k210_yolo_framework_tpu_torch.ops import yolo_head_pallas as TH

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
    got = TH.fused_decode_nms(preds, spec, hws, thresh, 0.3, 30, class_softmax)
    torch.cuda.synchronize()
    assert TH.fused_decode_nms.launches == before + 1
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
    limit = TH._max_candidates(dev)
    optin = getattr(torch.cuda.get_device_properties(dev),
                    "shared_memory_per_block_optin", None)
    if optin is not None:
        # the kernel's static shared memory (80 bytes) comes off the limit
        assert 0 < limit * 20 <= optin - 80
    big = torch.zeros((1, limit + 1, 25), device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        TH._launch(big, torch.zeros((8, limit + 1), device=dev),
                   lbox[:1].contiguous(), **kw)
    # the largest accepted candidate count launches
    TH._launch(big[:, :limit].contiguous(), torch.zeros((8, limit), device=dev),
               lbox[:1].contiguous(), **kw)
    torch.cuda.synchronize()


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

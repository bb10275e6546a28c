"""The port's native module (``k210_yolo_framework_tpu_torch/native.py``)
against the JAX package's: the same C++ sources, so every result is held
equal exactly.

The JAX package's libraries are built by its own ``make`` at first use,
which this file reaches only inside a fixture or a test, never while the
module is imported.  If that first load fails (another process's ``make``
may have been writing the library), the fixture clears the JAX module's
cache once and retries.
"""

import contextlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from k210_yolo_framework_tpu.data import pipeline as JPL
from k210_yolo_framework_tpu_torch import native as TN
from k210_yolo_framework_tpu_torch.data import pipeline as TPL

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jnative():
    from k210_yolo_framework_tpu import native as jn

    if not jn.available():
        jn._libs.clear()
        if not jn.available():
            pytest.skip("the JAX package's native libraries do not build")
    return jn


@pytest.fixture(scope="module")
def ann(tmp_path_factory):
    return JPL.synthetic_ann_list(str(tmp_path_factory.mktemp("native")),
                                  n=12, class_num=3, seed=3)


@pytest.fixture
def isolated(tmp_path, monkeypatch):
    """The port's native module with an empty build directory and no
    library loaded or failure remembered; returns a copy of ``csrc/``
    that the module compiles from."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("loader.cpp", "region_layer.cpp"):
        (csrc / name).write_bytes((REPO / "csrc" / name).read_bytes())
    monkeypatch.setattr(TN, "_CSRC", csrc)
    monkeypatch.setattr(TN, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(TN, "_libs", {})
    monkeypatch.setattr(TN, "_errors", {})
    return csrc


def test_native_loader_matches_jax_over_two_epochs(jnative, ann):
    paths = [str(r[0]) for r in ann]
    args = (paths, (512, 512), 4, 7, 3, 2)
    a, b = jnative.NativeLoader(*args), TN.NativeLoader(*args)
    try:
        seen = []
        for _ in range(2 * len(paths) // 4):
            got, want = b.next(), a.next()
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
            seen.extend(got[2].tolist())
    finally:
        a.close()
        b.close()
    assert np.bincount(seen, minlength=len(paths)).tolist() == [2] * 12


@pytest.mark.parametrize("kind", ["jpeg", "oversized_jpeg", "png"])
def test_decode_image_matches_jax(jnative, tmp_path, kind):
    rng = np.random.default_rng(9)
    shape = (700, 900, 3) if kind == "oversized_jpeg" else (301, 457, 3)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / ("img.png" if kind == "png" else "img.jpg"))
    Image.fromarray(img).save(path)
    canvas, hw = TN.decode_image(path, (512, 512))
    want_canvas, want_hw = jnative.decode_image(path, (512, 512))
    np.testing.assert_array_equal(hw, want_hw)
    np.testing.assert_array_equal(canvas, want_canvas)
    if kind == "oversized_jpeg":
        s = min(512 / 700, 512 / 900)
        assert tuple(hw) == (int(700 * s), int(900 * s))
    else:
        assert tuple(hw) == shape[:2]
    if kind == "png":                        # lossless: the pixels as saved
        np.testing.assert_array_equal(canvas[:301, :457], img)
    assert not canvas[hw[0]:].any() and not canvas[:, hw[1]:].any()


@pytest.mark.parametrize("class_softmax", [False, True])
def test_region_layer_matches_jax(jnative, class_softmax):
    rng = np.random.default_rng(11)
    anchors = np.sort(rng.uniform(0.05, 0.9, (2, 3, 2)).astype(
        np.float32))[:, ::-1]
    preds = [rng.normal(0, 2, (h, w, 3, 5 + 6)).astype(np.float32)
             for h, w in ((7, 10), (14, 20))]
    args = (preds, anchors, (224, 320), (375, 500), 0.3, 0.45, 30,
            class_softmax)
    got, want = TN.region_layer_run(*args), jnative.region_layer_run(*args)
    assert got[3].any()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_default_pipeline_is_the_jax_default(jnative, ann):
    """Fault o: with no ``use_native`` both packages pick the C++ loader
    and yield the same batches for the same seed."""
    j = JPL.DataPipeline(ann, 4, seed=5, num_workers=2)
    t = TPL.DataPipeline(ann, 4, seed=5, num_workers=2)
    assert j.use_native and t.use_native
    with contextlib.closing(iter(j)) as jit, contextlib.closing(iter(t)) as tit:
        for _ in range(4):                   # crosses an epoch boundary
            for a, b in zip(next(jit), next(tit)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_missing_image_raises_ioerror(ann, tmp_path):
    missing = str(tmp_path / "missing.jpg")
    with pytest.raises(IOError, match="missing.jpg"):
        TN.decode_image(missing, (64, 64))
    loader = TN.NativeLoader([missing], (64, 64), 1, 0, 1, 1)
    try:
        with pytest.raises(IOError, match="missing.jpg"):
            loader.next()
    finally:
        loader.close()
    rows = ann.copy()
    rows[2] = np.array([missing, rows[2][1], rows[2][2]], dtype=object)
    with contextlib.closing(iter(TPL.DataPipeline(rows, 12, 0,
                                                  use_native=True))) as it:
        with pytest.raises(IOError, match="missing.jpg"):
            next(it)


def test_processes_build_into_one_empty_directory_at_once(tmp_path):
    """Four processes start on an empty build directory together; each
    compiles to a temporary name and renames, so all four load a whole
    library and no temporary file is left."""
    code = r"""
import sys
from pathlib import Path
from k210_yolo_framework_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
assert native.available(), native.build_error()
print(sorted(native._library_path(n).name for n in native._SOURCES))
"""
    build = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    names = {out.strip() for out, _ in outs}
    assert len(names) == 1
    assert str(sorted(f.name for f in build.iterdir())) == names.pop()


def test_failed_build_is_retried_once_then_raises_its_error(isolated, ann,
                                                            monkeypatch):
    (isolated / "loader.cpp").write_text('#include "no_such_header.h"\n')
    broken = TN._library_path("yolo_loader")
    compiles = []
    run = subprocess.run

    def counting_run(cmd, *a, **kw):
        compiles.append(next(Path(c).name for c in cmd if c.endswith(".cpp")))
        return run(cmd, *a, **kw)

    monkeypatch.setattr(TN.subprocess, "run", counting_run)
    assert not TN.available()
    assert compiles.count("loader.cpp") == 2          # one retry
    assert "no_such_header.h" in TN.build_error()
    for call in (lambda: TN.NativeLoader([str(ann[0][0])], (64, 64), 1, 0),
                 lambda: TN.decode_image(str(ann[0][0]), (64, 64)),
                 lambda: next(iter(TPL.DataPipeline(ann, 2, 0,
                                                    use_native=True)))):
        with pytest.raises(RuntimeError, match="no_such_header.h"):
            call()
    assert compiles.count("loader.cpp") == 2          # remembered
    assert TPL.DataPipeline(ann, 2, 0).use_native is False
    # the source repaired: build() tries again, under a new library name
    (isolated / "loader.cpp").write_bytes(
        (REPO / "csrc" / "loader.cpp").read_bytes())
    assert TN._library_path("yolo_loader") != broken
    assert TN.build() and TN.available() and TN.build_error() == ""
    canvas, hw = TN.decode_image(str(ann[0][0]), (512, 512))
    assert tuple(hw) == tuple(ann[0][2])


def test_library_is_reused_until_its_source_changes(isolated):
    assert TN.available()
    lib = TN._library_path("yolo_region")
    stamp = lib.stat().st_mtime_ns
    TN._libs.clear()
    assert TN.available() and lib.stat().st_mtime_ns == stamp
    src = isolated / "region_layer.cpp"
    src.write_text(src.read_text() + "\n// edited\n")
    assert TN._library_path("yolo_region") != lib

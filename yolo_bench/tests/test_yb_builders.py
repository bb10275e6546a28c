"""A net that ``reference.nets.BUILDERS`` lacks is built from its builder
file, ``reference/builders/<model_def>.py``; the file's ``decode``, where it
has one, is the decode the serving check holds the program to.  Shown on
tiny_yolo, a small serving cell cut from ``v1-serve-b128`` with its
``model_def`` overridden."""

import shutil

import pytest

from yolo_bench.reference import nets as RN
from yolo_bench.tests import _small

TINY = {"config": {"model_def": "tiny_yolo"}}

SHIFTED = '''

def decode(logits, anchors, in_hw, img_hws):
    """serve.decode's boxes moved by a tenth of the image down and right."""
    import torch
    from yolo_bench.reference import serve
    boxes, scores = serve.decode(logits, anchors, in_hw, img_hws)
    hw = img_hws.to(torch.float32)
    return boxes + 0.1 * torch.cat([hw, hw], -1)[:, None, :], scores
'''


def test_an_unknown_name_lists_both_places():
    with pytest.raises(KeyError) as err:
        RN.build("no_such_net", 3, 20)
    assert "BUILDERS" in str(err.value)
    assert "builders/no_such_net.py" in str(err.value)


def test_a_name_missing_from_builders_is_built_from_its_file(tmp_path,
                                                             monkeypatch):
    assert "tiny_yolo" not in RN.BUILDERS
    net = RN.build("tiny_yolo", 3, 20)
    assert type(net).__name__ == "Net"
    assert type(net).__module__ == "yolo_bench_builder_tiny_yolo"
    (tmp_path / "toy.py").write_text(
        "from yolo_bench.reference import nets as RN\n\n\n"
        "class Net(RN.HeadConv):\n"
        "    def __init__(self, anchors, classes, alpha):\n"
        "        super().__init__(3, anchors * (5 + classes))\n"
        "        self.alpha = alpha\n")
    monkeypatch.setattr(RN, "BUILDER_DIR", tmp_path)
    toy = RN.build("toy", 2, 1, 0.5)
    assert toy.alpha == 0.5
    assert toy.dark_conv_out.weight.shape == (12, 3, 1, 1)


def test_a_tiny_yolo_serving_cell_is_correct():
    line = _small.run("v1-serve-b128", **TINY)
    assert line["correct"] is True, line["check"]
    assert line["detail"]["served"] > 0


def _shifted(tmp_path, monkeypatch):
    """tiny_yolo's builder file with ``SHIFTED`` appended, in its own
    folder (a builder file is loaded once a process, by path)."""
    src = RN.BUILDER_DIR / "tiny_yolo.py"
    (tmp_path / "shifted").mkdir()
    (tmp_path / "shifted" / "tiny_yolo.py").write_text(src.read_text() +
                                                       SHIFTED)
    monkeypatch.setattr(RN, "BUILDER_DIR", tmp_path / "shifted")


def test_the_builder_files_decode_is_the_one_the_check_uses(tmp_path,
                                                            monkeypatch):
    """A copy of tiny_yolo's file passes; a copy with a decode that shifts
    the boxes fails."""
    (tmp_path / "plain").mkdir()
    shutil.copy(RN.BUILDER_DIR / "tiny_yolo.py",
                tmp_path / "plain" / "tiny_yolo.py")
    with monkeypatch.context() as m:
        m.setattr(RN, "BUILDER_DIR", tmp_path / "plain")
        assert _small.run("v1-serve-b128", seed=6, **TINY)["correct"] is True
    _shifted(tmp_path, monkeypatch)
    line = _small.run("v1-serve-b128", seed=6, **TINY)
    assert line["correct"] is False, line["check"]


def test_a_builder_file_is_loaded_once():
    assert RN.builder_file("tiny_yolo") is RN.builder_file("tiny_yolo")
    assert type(RN.build("tiny_yolo", 3, 20)) is type(
        RN.build("tiny_yolo", 3, 20))


def test_a_train_cell_refuses_a_net_with_its_own_decode(tmp_path,
                                                        monkeypatch):
    """``reference/train.py`` is YOLOv3's loss and decode: a builder file
    with a decode of its own is refused before anything is built."""
    _shifted(tmp_path, monkeypatch)
    with pytest.raises(ValueError, match="reference/train.py"):
        _small.run("v1-train-b128", **TINY)

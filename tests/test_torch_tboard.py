"""The port's TensorBoard event writer and reader against the JAX
package's: crc32c vectors, files of either package read by both readers
alike, and corruption detected."""

import numpy as np
import pytest

from k210_yolo_framework_tpu.utils import tboard as JTB
from k210_yolo_framework_tpu_torch.utils import tboard as TTB


@pytest.mark.parametrize("data,crc", [(b"123456789", 0xE3069283),
                                      (b"", 0x0),
                                      (b"\x00" * 32, 0x8A9136AA),
                                      (b"\xff" * 32, 0x62A8AB43)])
def test_crc32c_vectors(data, crc):
    """The Castagnoli vectors (RFC 3720, B.4), the masked form as JAX's."""
    assert TTB._crc32c(data) == crc == JTB._crc32c(data)
    assert TTB._masked_crc(data) == JTB._masked_crc(data)


def _write(mod, log_dir):
    w = mod.SummaryWriter(str(log_dir))
    w.add_scalar("loss", 12.5, step=1)
    w.add_scalars([("loss", 10.0), ("p", 0.25), ("sparsity", 0.8999)],
                  step=2)
    w.add_scalars([("lr", 1e-3)], step=300)
    w.close()
    return w.path


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_events_read_alike_by_both_readers(tmp_path, writer):
    path = _write(TTB if writer == "port" else JTB, tmp_path)
    port, jax_ = list(TTB.read_events(path)), list(JTB.read_events(path))
    assert len(port) == len(jax_) == 4
    for a, b in zip(port, jax_):
        assert a == b
    assert port[0]["file_version"] == "brain.Event:2"
    assert [e["step"] for e in port] == [0, 1, 2, 300]
    assert port[1]["scalars"] == {"loss": 12.5}
    assert port[2]["scalars"]["loss"] == 10.0
    np.testing.assert_allclose(port[2]["scalars"]["sparsity"], 0.8999,
                               rtol=1e-7)
    np.testing.assert_allclose(port[3]["scalars"]["lr"], 1e-3, rtol=1e-7)


def test_port_writes_jax_bytes_but_the_wall_times(tmp_path, monkeypatch):
    """Frozen clocks and host name: the two writers' files are equal."""
    for mod in (TTB, JTB):
        monkeypatch.setattr(mod.time, "time", lambda: 1_700_000_000.25)
        monkeypatch.setattr(mod.socket, "gethostname", lambda: "host")
    a = _write(TTB, tmp_path / "port")
    b = _write(JTB, tmp_path / "jax")
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("where", ["payload", "length"])
def test_corruption_is_detected(tmp_path, where):
    path = _write(TTB, tmp_path)
    raw = bytearray(open(path, "rb").read())
    raw[-6 if where == "payload" else 0] ^= 0xFF
    bad = tmp_path / "bad"
    bad.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match=f"{where} crc mismatch"):
        list(TTB.read_events(str(bad)))

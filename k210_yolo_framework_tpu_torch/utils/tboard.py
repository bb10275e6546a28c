"""Minimal TensorBoard event-file writer and reader (no TensorFlow).

Counterpart of ``k210_yolo_framework_tpu/utils/tboard.py`` (a copy: the port
loads nothing of the JAX package); files written by either package read
back with either ``read_events``.  Implements just enough in pure Python:

  * TFRecord framing: u64-LE length, masked crc32c(length), payload,
    masked crc32c(payload);
  * Event / Summary proto encoding by hand (varint + fixed fields) for
    ``file_version`` and ``simple_value`` summaries.

``read_events`` raises ``ValueError`` on a record whose crc does not match.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Iterator, List, Optional, Tuple

__all__ = ["SummaryWriter", "read_events"]

# ----------------------------------------------------------- crc32c ------

_CRC_TABLE: List[int] = []


def _crc_table() -> List[int]:
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78  # Castagnoli, reflected
        tbl = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ (poly if c & 1 else 0)
            tbl.append(c)
        _CRC_TABLE = tbl
    return _CRC_TABLE


def _crc32c(data: bytes) -> int:
    tbl = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------ proto encode ------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _str_field(field: int, s: bytes) -> bytes:
    return _key(field, 2) + _varint(len(s)) + s


def _encode_value(tag: str, value: float) -> bytes:
    # Summary.Value { string tag = 1; float simple_value = 2; }
    return (_str_field(1, tag.encode()) +
            _key(2, 5) + struct.pack("<f", value))


def _encode_event(wall_time: float, step: int = 0,
                  file_version: Optional[str] = None,
                  scalars: Optional[List[Tuple[str, float]]] = None) -> bytes:
    # Event { double wall_time = 1; int64 step = 2;
    #         string file_version = 3; Summary summary = 5; }
    out = _key(1, 1) + struct.pack("<d", wall_time)
    if step:
        out += _key(2, 0) + _varint(step)
    if file_version is not None:
        out += _str_field(3, file_version.encode())
    if scalars:
        summary = b"".join(_str_field(1, _encode_value(t, v)) for t, v in scalars)
        out += _str_field(5, summary)
    return out


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header)) +
            payload + struct.pack("<I", _masked_crc(payload)))


# ------------------------------------------------------------ writer ------

class SummaryWriter:
    """Append scalar summaries to a ``events.out.tfevents.*`` file."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{time.time():.6f}.{socket.gethostname()}"
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._f.write(_record(_encode_event(time.time(),
                                            file_version="brain.Event:2")))

    def add_scalar(self, tag: str, value: float, step: int):
        self.add_scalars([(tag, value)], step)

    def add_scalars(self, scalars: List[Tuple[str, float]], step: int):
        self._f.write(_record(_encode_event(time.time(), step=step,
                                            scalars=[(t, float(v))
                                                     for t, v in scalars])))
        # flushed per call: a killed run keeps every event written so far
        self._f.flush()

    def flush(self):
        self._f.flush()

    def close(self):
        if not self._f.closed:
            self._f.flush()
            self._f.close()


# ------------------------------------------------------------ reader ------

def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def read_events(path: str) -> Iterator[dict]:
    """Parse the events of a file back: dicts with ``step``, ``scalars``
    ({tag: value}), ``wall_time`` and, on the first, ``file_version``."""
    with open(path, "rb") as f:
        data = f.read()
    i = 0
    while i < len(data):
        (length,) = struct.unpack_from("<Q", data, i)
        header = data[i:i + 8]
        (hcrc,) = struct.unpack_from("<I", data, i + 8)
        if hcrc != _masked_crc(header):
            raise ValueError(f"{path}: length crc mismatch at byte {i}")
        payload = data[i + 12:i + 12 + length]
        (pcrc,) = struct.unpack_from("<I", data, i + 12 + length)
        if pcrc != _masked_crc(payload):
            raise ValueError(f"{path}: payload crc mismatch at byte {i}")
        i += 12 + length + 4

        ev = {"step": 0, "scalars": {}}
        j = 0
        while j < len(payload):
            key, j = _read_varint(payload, j)
            field, wire = key >> 3, key & 7
            if field == 1 and wire == 1:
                (ev["wall_time"],) = struct.unpack_from("<d", payload, j)
                j += 8
            elif field == 2 and wire == 0:
                ev["step"], j = _read_varint(payload, j)
            elif field == 3 and wire == 2:
                ln, j = _read_varint(payload, j)
                ev["file_version"] = payload[j:j + ln].decode()
                j += ln
            elif field == 5 and wire == 2:
                ln, j = _read_varint(payload, j)
                summ = payload[j:j + ln]
                j += ln
                k = 0
                while k < len(summ):
                    vkey, k = _read_varint(summ, k)
                    vln, k = _read_varint(summ, k)
                    val = summ[k:k + vln]
                    k += vln
                    if vkey >> 3 == 1:
                        m = 0
                        tag, sv = None, None
                        while m < len(val):
                            fkey, m = _read_varint(val, m)
                            if fkey >> 3 == 1 and fkey & 7 == 2:
                                fl, m = _read_varint(val, m)
                                tag = val[m:m + fl].decode()
                                m += fl
                            elif fkey >> 3 == 2 and fkey & 7 == 5:
                                (sv,) = struct.unpack_from("<f", val, m)
                                m += 4
                            else:  # skip unknown
                                if fkey & 7 == 0:
                                    _, m = _read_varint(val, m)
                                elif fkey & 7 == 2:
                                    fl, m = _read_varint(val, m)
                                    m += fl
                                else:
                                    m += 8 if fkey & 7 == 1 else 4
                        if tag is not None:
                            ev["scalars"][tag] = sv
            else:  # skip unknown field
                if wire == 0:
                    _, j = _read_varint(payload, j)
                elif wire == 2:
                    ln, j = _read_varint(payload, j)
                    j += ln
                else:
                    j += 8 if wire == 1 else 4
        yield ev

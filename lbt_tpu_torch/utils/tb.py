"""Dependency-free TensorBoard event-file writer (the writer of
``lbt_tpu/utils/tb.py``, copied: the port cannot import it without loading
JAX through ``lbt_tpu/__init__.py``).

The reference logs per-layer range/mean scalars plus loss/accuracy to
TensorBoard (reference dynamic_fixed_point.py:275-285, trainer.py:66-73).
This environment has no TensorFlow, so scalar summaries are serialized
by hand: TFRecord framing (length + masked CRC32C) around a minimal
protobuf encoding of `tensorflow.Event { wall_time, step, summary {
value { tag, simple_value } } }`.  Files are readable by stock
TensorBoard and by ``lbt_tpu.utils.tb.read_events``.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict

# -- CRC32C (Castagnoli), table-driven --------------------------------------

_POLY = 0x82F63B78
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (_POLY if _c & 1 else 0)
    _TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- minimal protobuf encoding ----------------------------------------------


def varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return varint((field << 3) | wire)


def _pb_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _pb_int64(field: int, v: int) -> bytes:
    return _tag(field, 0) + varint(v & 0xFFFFFFFFFFFFFFFF)


def _pb_bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + varint(len(v)) + v


def _event(wall_time: float, step: int, payload: bytes = b"",
           file_version: str = "") -> bytes:
    # Event: 1=wall_time double, 2=step int64, 3=file_version string,
    #        5=summary Summary
    msg = _pb_double(1, wall_time) + _pb_int64(2, step)
    if file_version:
        msg += _pb_bytes(3, file_version.encode())
    if payload:
        msg += _pb_bytes(5, payload)
    return msg


def _scalar_summary(values: Dict[str, float]) -> bytes:
    # Summary: repeated Value value=1; Value: 1=tag string, 2=simple_value
    out = b""
    for tag, v in values.items():
        val = _pb_bytes(1, tag.encode()) + _pb_float(2, float(v))
        out += _pb_bytes(1, val)
    return out


class EventWriter:
    """Append-only tfevents file of scalar summaries."""

    def __init__(self, logdir: str, suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        name = "events.out.tfevents.%010d.%s%s" % (
            int(time.time()), socket.gethostname(), suffix)
        self._f = open(os.path.join(logdir, name), "ab")
        self._record(_event(time.time(), 0, file_version="brain.Event:2"))

    def _record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", masked_crc(payload)))
        self._f.flush()

    def scalars(self, step: int, values: Dict[str, float]):
        if not values:
            return
        self._record(
            _event(time.time(), int(step), _scalar_summary(values)))

    def close(self):
        self._f.close()

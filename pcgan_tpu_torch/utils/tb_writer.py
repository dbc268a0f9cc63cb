"""TensorBoard event-file writer, stdlib only (counterpart of ``pcgan_tpu/utils/tb_writer.py``).

``metrics.jsonl`` stays the machine-readable record; ``--tb_logdir``
additionally mirrors every logged scalar into a standard
``events.out.tfevents.*`` file that a stock TensorBoard reads, without
tensorflow or the tensorboard package at write time. The bytes are the
JAX package's: the same records for the same scalars.

Two formats are hand-encoded here:

* **protobuf wire format** for ``tensorflow.Event`` scalar records:
  ``Event{wall_time=1(double), step=2(int64), file_version=3(string),
  summary=5(Summary{value=1(repeated Value{tag=1(string),
  simple_value=2(float)})})}`` (field numbers from
  tensorflow/core/util/event.proto and summary.proto, the "brain.Event:2"
  file version).
* **TFRecord framing**: ``uint64 len | uint32 masked_crc(len) | data |
  uint32 masked_crc(data)`` with CRC32C (Castagnoli) and the TFRecord
  mask ``rot15(crc) + 0xa282ead8``.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Optional

# ---- CRC32C (Castagnoli, reflected poly 0x82F63B78), table-driven ----

def _make_table():
    tbl = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        tbl.append(c)
    return tbl


_CRC_TABLE = _make_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---- minimal protobuf wire-format encoding ----

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _scalar_event(step: int, wall_time: float,
                  scalars: Dict[str, float]) -> bytes:
    values = b""
    for tag, v in scalars.items():
        val = (_len_delim(1, tag.encode("utf-8"))
               + _key(2, 5) + struct.pack("<f", float(v)))
        values += _len_delim(1, val)
    return (_key(1, 1) + struct.pack("<d", wall_time)
            + _key(2, 0) + _varint(int(step))
            + _len_delim(5, values))


def _record(data: bytes) -> bytes:
    hdr = struct.pack("<Q", len(data))
    return (hdr + struct.pack("<I", _masked_crc(hdr))
            + data + struct.pack("<I", _masked_crc(data)))


class TBWriter:
    """Append-only scalar event file under ``logdir`` (one TensorBoard
    "run" per directory — point ``tensorboard --logdir`` at the parent)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        now = time.time()
        fname = f"events.out.tfevents.{now:.6f}.{socket.gethostname()}"
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        # mandatory first record: file_version "brain.Event:2"
        ver = (_key(1, 1) + struct.pack("<d", now)
               + _len_delim(3, b"brain.Event:2"))
        self._f.write(_record(ver))
        self._f.flush()

    def add_scalars(self, step: int, scalars: Dict[str, float],
                    wall_time: Optional[float] = None):
        if not scalars:
            return
        ev = _scalar_event(step, time.time() if wall_time is None
                           else wall_time, scalars)
        self._f.write(_record(ev))
        self._f.flush()

    def close(self):
        self._f.close()

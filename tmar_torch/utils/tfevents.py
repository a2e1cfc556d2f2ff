"""Minimal TensorBoard scalar writer — no tensorflow/tensorboard dependency.

The port's own copy of ``tmar.utils.tfevents`` (pure Python).  The Trainer
logs per-loss scalars and ``Val/*`` through it.  It writes the tfevents
format directly: a TFRecord stream of protobuf-encoded ``Event`` messages.
Only the scalar (``simple_value``) summary type is emitted; files load in
stock TensorBoard.

Wire format notes (kept here because there is no proto dependency):

* TFRecord framing: ``uint64 len | uint32 masked_crc(len) | data |
  uint32 masked_crc(data)``; crc is CRC-32C (Castagnoli), masked as
  ``((c >> 15 | c << 17) + 0xa282ead8) & 0xffffffff``.
* ``Event``: field 1 ``wall_time`` (double), 2 ``step`` (int64),
  3 ``file_version`` (string), 5 ``summary`` (message).
* ``Summary``: field 1 repeated ``Value``; ``Value``: field 1 ``tag``
  (string), 2 ``simple_value`` (float32).
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Iterator, List, Optional, Tuple

# ---------------------------------------------------------------- crc32c

_CRC_TABLE: List[int] = []


def _crc_table() -> List[int]:
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78  # reflected Castagnoli
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    c = 0xFFFFFFFF
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return ((c >> 15 | c << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------- protobuf

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
    return _varint(field << 3 | wire)


def _f_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f_varint(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _event(wall_time: float, step: int = 0, file_version: str = "",
           scalars: Optional[Dict[str, float]] = None) -> bytes:
    msg = _f_double(1, wall_time)
    if step:
        msg += _f_varint(2, step)
    if file_version:
        msg += _f_bytes(3, file_version.encode())
    if scalars:
        summary = b""
        for tag, value in scalars.items():
            val = _f_bytes(1, tag.encode()) + _f_float(2, float(value))
            summary += _f_bytes(1, val)
        msg += _f_bytes(5, summary)
    return msg


# --------------------------------------------------------------- writer

class TBWriter:
    """Append-only scalar event writer; one tfevents file per instance."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab")
        self._record(_event(time.time(), file_version="brain.Event:2"))

    def _record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._record(_event(time.time(), step=step, scalars={tag: value}))

    def scalars(self, values: Dict[str, float], step: int) -> None:
        """One event carrying several scalar values (cheaper than N events)."""
        self._record(_event(time.time(), step=step, scalars=values))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        try:
            self._f.flush()
            self._f.close()
        except Exception:
            pass


# --------------------------------------------------------------- reader
# Used by tests (and handy for quick inspection without TensorBoard).

def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    out = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _parse_fields(buf: bytes) -> Iterator[Tuple[int, int, bytes]]:
    i = 0
    while i < len(buf):
        k, i = _read_varint(buf, i)
        field, wire = k >> 3, k & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
            yield field, wire, _varint(v)
        elif wire == 1:
            yield field, wire, buf[i:i + 8]
            i += 8
        elif wire == 2:
            n, i = _read_varint(buf, i)
            yield field, wire, buf[i:i + n]
            i += n
        elif wire == 5:
            yield field, wire, buf[i:i + 4]
            i += 4
        else:  # pragma: no cover
            raise ValueError(f"unsupported wire type {wire}")


def read_scalars(path: str, check_crc: bool = True):
    """Parse a tfevents file -> list of (step, tag, value)."""
    out = []
    with open(path, "rb") as f:
        raw = f.read()
    i = 0
    while i < len(raw):
        (n,) = struct.unpack("<Q", raw[i:i + 8])
        if check_crc:
            (hc,) = struct.unpack("<I", raw[i + 8:i + 12])
            assert hc == _masked_crc(raw[i:i + 8]), "header crc mismatch"
        data = raw[i + 12:i + 12 + n]
        if check_crc:
            (dc,) = struct.unpack("<I", raw[i + 12 + n:i + 16 + n])
            assert dc == _masked_crc(data), "data crc mismatch"
        i += 16 + n
        step = 0
        scalars = []
        for field, wire, val in _parse_fields(data):
            if field == 2 and wire == 0:
                step, _ = _read_varint(val, 0)
            elif field == 5 and wire == 2:
                for f2, w2, v2 in _parse_fields(val):
                    if f2 == 1 and w2 == 2:
                        tag, value = "", None
                        for f3, w3, v3 in _parse_fields(v2):
                            if f3 == 1 and w3 == 2:
                                tag = v3.decode()
                            elif f3 == 2 and w3 == 5:
                                (value,) = struct.unpack("<f", v3)
                        if value is not None:
                            scalars.append((tag, value))
        for tag, value in scalars:
            out.append((step, tag, value))
    return out

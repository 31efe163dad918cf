"""Dependency-free TensorBoard event writer (a copy of the JAX package's
``bayeformers_tpu/utils/tb.py``, which the port may not import).

The reference logs per-phase scalars through tensorboardX
(`examples/bert_glue.py:93,141-142`); the JSONL MetricsWriter
(utils/metrics.py) is the primary sink, and this module writes genuine
TensorBoard event files beside it (TFRecord-framed `tensorflow.Event` protos
with masked CRC32C checksums) with a hand-rolled encoder for exactly the two
messages scalar logging needs: no tensorflow/tensorboardX dependency. Files
are readable by any stock TensorBoard (`tensorboard --logdir ...`).

Wire format implemented:
- TFRecord: u64-LE length, u32-LE masked-crc32c(length), payload,
  u32-LE masked-crc32c(payload); mask(c) = ((c>>15 | c<<17) + 0xa282ead8).
- Event proto: wall_time (field 1, double), step (field 2, varint),
  file_version (3, string) or summary (5, message).
- Summary proto: repeated Value (field 1); Value: tag (1, string),
  simple_value (2, float32).
"""
from __future__ import annotations

import os
import socket
import struct
import time


def _crc32c_table():
    poly = 0x82F63B78
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # proto int64 wire form
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _bytes_field(num: int, payload: bytes) -> bytes:
    return _field(num, 2) + _varint(len(payload)) + payload


def _scalar_value(tag: str, value: float) -> bytes:
    v = _bytes_field(1, tag.encode()) + _field(2, 5) + struct.pack(
        "<f", float(value)
    )
    return _bytes_field(1, v)  # Summary.value entry


def _event(wall_time: float, step: int | None = None,
           file_version: str | None = None,
           scalars: dict[str, float] | None = None) -> bytes:
    out = _field(1, 1) + struct.pack("<d", wall_time)
    if step is not None:
        out += _field(2, 0) + _varint(step)
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if scalars:
        summary = b"".join(_scalar_value(t, v) for t, v in scalars.items())
        out += _bytes_field(5, summary)
    return out


class EventWriter:
    """Append-only writer of one `events.out.tfevents.*` file."""

    def __init__(self, logdir: str, run: str = ""):
        path = os.path.join(logdir, run) if run else logdir
        os.makedirs(path, exist_ok=True)
        fname = (
            f"events.out.tfevents.{int(time.time())}."
            f"{socket.gethostname()}.{os.getpid()}"
        )
        self.path = os.path.join(path, fname)
        self._f = open(self.path, "ab")
        self._record(_event(time.time(), file_version="brain.Event:2"))

    def _record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))
        self._f.flush()

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._record(_event(time.time(), step=step, scalars={tag: value}))

    def scalars(self, prefix: str, values: dict, step: int) -> None:
        payload = {
            f"{prefix}/{k}": float(v) for k, v in values.items()
            if isinstance(v, (int, float))
        }
        if payload:
            self._record(_event(time.time(), step=step, scalars=payload))

    def close(self) -> None:
        self._f.close()


def read_events(path: str):
    """Parse an event file back (the dependency-free integrity check used by
    tests): yields (step, {tag: value}) for scalar events."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            assert hcrc == _masked_crc(header), "corrupt length crc"
            payload = f.read(length)
            (pcrc,) = struct.unpack("<I", f.read(4))
            assert pcrc == _masked_crc(payload), "corrupt payload crc"
            yield _parse_event(payload)


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = n = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _parse_event(buf: bytes):
    i = 0
    step = 0
    scalars: dict[str, float] = {}
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 1:
            i += 8
        elif wire == 5:
            i += 4
        elif wire == 0:
            val, i = _read_varint(buf, i)
            if num == 2:
                step = val
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            chunk = buf[i:i + ln]
            i += ln
            if num == 5:  # summary
                j = 0
                while j < len(chunk):
                    k2, j = _read_varint(chunk, j)
                    if k2 >> 3 == 1 and k2 & 7 == 2:
                        vlen, j = _read_varint(chunk, j)
                        value = chunk[j:j + vlen]
                        j += vlen
                        tag, sv = None, None
                        m = 0
                        while m < len(value):
                            k3, m = _read_varint(value, m)
                            if k3 >> 3 == 1 and k3 & 7 == 2:
                                tlen, m = _read_varint(value, m)
                                tag = value[m:m + tlen].decode()
                                m += tlen
                            elif k3 >> 3 == 2 and k3 & 7 == 5:
                                (sv,) = struct.unpack(
                                    "<f", value[m:m + 4]
                                )
                                m += 4
                            else:
                                break
                        if tag is not None and sv is not None:
                            scalars[tag] = sv
                    else:
                        break
    return step, scalars

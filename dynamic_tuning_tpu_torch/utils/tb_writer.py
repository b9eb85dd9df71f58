"""TensorBoard event-file writer, dependency-free (a copy of
dynamic_tuning_tpu/utils/tb_writer.py).

The reference logs scalars through torch's SummaryWriter
(engine_finetune.py:95-101, main_image.py:300-312) so its runs are
TensorBoard-loadable.  Neither tensorflow nor the tensorboard package is
baked into this image, so this module hand-encodes the two protobufs a
scalar needs (Event{wall_time, step, summary{value{tag, simple_value}}})
and the TFRecord framing (length + masked-CRC32C, as written by
tensorflow/core/lib/io/record_writer.cc) — ~100 lines, zero deps, and the
output loads in stock TensorBoard.

Format notes (protobuf wire format):
  Event.wall_time    field 1, 64-bit   -> key 0x09
  Event.step         field 2, varint   -> key 0x10
  Event.file_version field 3, bytes    -> key 0x1a  (first record only)
  Event.summary      field 5, bytes    -> key 0x2a
  Summary.value      field 1, bytes    -> key 0x0a
  Value.tag          field 1, bytes    -> key 0x0a
  Value.simple_value field 2, 32-bit   -> key 0x15
"""

from __future__ import annotations

import os
import socket
import struct
import time

# --- CRC32C (Castagnoli, reflected poly 0x82F63B78) --------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    """TFRecord's rotated+offset CRC mask (record_writer.cc::MaskedCrc)."""
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# --- minimal protobuf encoding ----------------------------------------------

def _varint(n: int) -> bytes:
    if n < 0:
        # proto varints encode negative int64 as 64-bit two's complement
        # (10 bytes); without this a negative step would loop forever
        n += 1 << 64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _bytes_field(key: int, payload: bytes) -> bytes:
    return bytes([key]) + _varint(len(payload)) + payload


def _scalar_event(tag: str, value: float, step: int, wall_time: float
                  ) -> bytes:
    val = (_bytes_field(0x0A, tag.encode()) +
           b"\x15" + struct.pack("<f", value))
    summary = _bytes_field(0x0A, val)
    return (b"\x09" + struct.pack("<d", wall_time) +
            b"\x10" + _varint(step) +
            _bytes_field(0x2A, summary))


def _version_event(wall_time: float) -> bytes:
    return (b"\x09" + struct.pack("<d", wall_time) +
            _bytes_field(0x1A, b"brain.Event:2"))


def _record(event: bytes) -> bytes:
    header = struct.pack("<Q", len(event))
    return (header + struct.pack("<I", _masked_crc(header)) +
            event + struct.pack("<I", _masked_crc(event)))


class EventFileWriter:
    """Writes ``events.out.tfevents.*`` scalar files TensorBoard can load."""

    _uid = 0

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        now = time.time()
        # pid + per-process counter uniquify like TF's EventsWriter does —
        # two writers born in the same second must not interleave records
        # into one file (TFRecord framing would corrupt)
        EventFileWriter._uid += 1
        self.path = os.path.join(
            log_dir,
            f"events.out.tfevents.{int(now)}.{socket.gethostname()}."
            f"{os.getpid()}.{EventFileWriter._uid}")
        self._fh = open(self.path, "ab")
        self._fh.write(_record(_version_event(now)))
        self._fh.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        self._fh.write(_record(
            _scalar_event(tag, float(value), int(step), time.time())))
        self._fh.flush()

    def close(self):
        self._fh.close()


def read_event_file(path: str):
    """Decode scalars back out of an event file (test/debug helper; verifies
    framing CRCs).  Yields (tag, value, step) tuples."""
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off < len(data):
        (ln,) = struct.unpack_from("<Q", data, off)
        (hcrc,) = struct.unpack_from("<I", data, off + 8)
        assert hcrc == _masked_crc(data[off:off + 8]), "header crc mismatch"
        ev = data[off + 12:off + 12 + ln]
        (dcrc,) = struct.unpack_from("<I", data, off + 12 + ln)
        assert dcrc == _masked_crc(ev), "data crc mismatch"
        off += 16 + ln
        step, summary = 0, None
        p = 0
        while p < len(ev):
            key = ev[p]
            p += 1
            if key == 0x09:                       # wall_time
                p += 8
            elif key == 0x10:                     # step
                step = 0
                shift = 0
                while True:
                    b = ev[p]
                    p += 1
                    step |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
            elif key in (0x1A, 0x2A):             # file_version / summary
                ln2, shift = 0, 0
                while True:
                    b = ev[p]
                    p += 1
                    ln2 |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
                if key == 0x2A:
                    summary = ev[p:p + ln2]
                p += ln2
            else:
                raise ValueError(f"unexpected Event key {key:#x}")
        if summary is None:
            continue
        # Summary { value { tag, simple_value } }
        assert summary[0] == 0x0A
        q = 1
        ln3, shift = 0, 0
        while True:
            b = summary[q]
            q += 1
            ln3 |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        val = summary[q:q + ln3]
        assert val[0] == 0x0A
        tlen = val[1]
        tag = val[2:2 + tlen].decode()
        assert val[2 + tlen] == 0x15
        (value,) = struct.unpack_from("<f", val, 3 + tlen)
        yield tag, value, step

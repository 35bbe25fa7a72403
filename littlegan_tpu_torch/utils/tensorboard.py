"""Minimal TensorBoard event-file writer, the port's copy of littlegan_tpu/utils/tensorboard.py.

The reference logs per-step scalars via ``tf.contrib.summary``
(eager_trainer.py:203-207) into ``result/<exp>/log`` and views them with the
``visual`` mode (main.py:34-36). This module writes the same on-disk format
(TFRecord-framed ``Event`` protobufs with masked CRC32C) by hand, so standard
TensorBoard can read our logs without TensorFlow being installed here.

Wire format implemented:
- TFRecord: u64 length | u32 masked_crc(length) | payload | u32 masked_crc(payload)
- Event proto: wall_time(1,double) step(2,int64) file_version(3,string)
  summary(5,msg); Summary { Value { tag(1,string) simple_value(2,float)
  image(4,msg) } }; Summary.Image { height(1) width(2) colorspace(3)
  encoded_image_string(4,bytes) } — the legacy image summary, which
  TensorBoard's image plugin still migrates and renders (beyond the
  reference, which logs scalars only — eager_trainer.py:203-207).
"""

from __future__ import annotations

import os
import struct
import time
from typing import Dict, Iterable, List, Tuple

# ------------------------------------------------------------------ crc32c --

_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78  # Castagnoli, reflected
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        _CRC_TABLE.append(crc)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ----------------------------------------------------------- proto encoding --


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


def _encode_value(tag: str, value: float) -> bytes:
    body = _len_delim(1, tag.encode()) + _key(2, 5) + struct.pack("<f", value)
    return body


def _encode_image_value(tag: str, height: int, width: int, colorspace: int, png: bytes) -> bytes:
    img = (
        _key(1, 0) + _varint(height)
        + _key(2, 0) + _varint(width)
        + _key(3, 0) + _varint(colorspace)
        + _len_delim(4, png)
    )
    return _len_delim(1, tag.encode()) + _len_delim(4, img)


def _encode_event(
    wall_time: float,
    step: int,
    scalars: Iterable[Tuple[str, float]] = (),
    file_version: str | None = None,
) -> bytes:
    ev = _key(1, 1) + struct.pack("<d", wall_time)
    ev += _key(2, 0) + _varint(step & 0xFFFFFFFFFFFFFFFF)
    if file_version is not None:
        ev += _len_delim(3, file_version.encode())
    vals = b"".join(_len_delim(1, _encode_value(t, v)) for t, v in scalars)
    if vals:
        ev += _len_delim(5, vals)
    return ev


# ------------------------------------------------------------------- writer --


class SummaryWriter:
    """Append-only scalar event writer, TensorBoard-compatible."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.littlegan.{os.getpid()}"
        self._f = open(os.path.join(logdir, fname), "ab", buffering=0)
        self._record(_encode_event(time.time(), 0, file_version="brain.Event:2"))

    def _record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(
            header
            + struct.pack("<I", _masked_crc(header))
            + payload
            + struct.pack("<I", _masked_crc(payload))
        )

    def scalar(self, tag: str, value: float, step: int) -> None:
        self.scalars([(tag, value)], step)

    def scalars(self, pairs: Iterable[Tuple[str, float]], step: int) -> None:
        pairs = [(t, float(v)) for t, v in pairs]
        if pairs:
            self._record(_encode_event(time.time(), step, pairs))

    def image(self, tag: str, array, step: int) -> None:
        """Log an HWC uint8 image (C in {1, 3, 4}) under TB's Images tab.

        PNG-encoded (lossless; TB accepts any format PIL writes). [-1,1]
        float batches should go through utils/image.py rescaling first —
        this method takes display-ready uint8 pixels.
        """
        import io

        import numpy as np
        from PIL import Image  # local import, same policy as utils/image.py

        arr = np.asarray(array)
        if arr.ndim != 3 or arr.dtype != np.uint8 or arr.shape[2] not in (1, 3, 4):
            raise ValueError(f"need HWC uint8 with 1/3/4 channels, got {arr.dtype} {arr.shape}")
        mode = {1: "L", 3: "RGB", 4: "RGBA"}[arr.shape[2]]
        buf = io.BytesIO()
        Image.fromarray(arr[:, :, 0] if mode == "L" else arr, mode).save(buf, format="PNG")
        value = _encode_image_value(tag, arr.shape[0], arr.shape[1], arr.shape[2], buf.getvalue())
        ev = _key(1, 1) + struct.pack("<d", time.time())
        ev += _key(2, 0) + _varint(step & 0xFFFFFFFFFFFFFFFF)
        ev += _len_delim(5, _len_delim(1, value))
        self._record(ev)

    def flush(self) -> None:
        os.fsync(self._f.fileno())

    def close(self) -> None:
        try:
            self.flush()
        finally:
            self._f.close()


# ------------------------------------------------------------------- reader --


def _decode_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[pos]
        out |= (b & 0x7F) << shift
        pos += 1
        if not b & 0x80:
            return out, pos
        shift += 7


def _iter_proto_fields(payload: bytes):
    """Yield (field_number, wire_type, value) over one proto message.

    value: int for varint(0)/fixed64(1)/fixed32(5), bytes for len-delim(2).
    Only the wire types the Event proto uses are implemented."""
    pos = 0
    while pos < len(payload):
        key, pos = _decode_varint(payload, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _decode_varint(payload, pos)
        elif wire == 1:
            val = struct.unpack_from("<Q", payload, pos)[0]
            pos += 8
        elif wire == 2:
            n, pos = _decode_varint(payload, pos)
            val = payload[pos : pos + n]
            pos += n
        elif wire == 5:
            val = struct.unpack_from("<I", payload, pos)[0]
            pos += 4
        else:  # groups (3/4): never produced by TB writers
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def iter_event_records(path: str):
    """Yield raw Event payloads from one TFRecord-framed event file.

    CRCs are verified (a corrupt record raises); a TRAILING partial record —
    a run killed mid-write — is tolerated and ends iteration."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        if pos + 12 > len(data):
            return  # trailing partial header
        (length,) = struct.unpack_from("<Q", data, pos)
        (len_crc,) = struct.unpack_from("<I", data, pos + 8)
        if _masked_crc(data[pos : pos + 8]) != len_crc:
            raise ValueError(f"corrupt record-length CRC at byte {pos} of {path}")
        start = pos + 12
        if start + length + 4 > len(data):
            return  # trailing partial payload
        payload = data[start : start + length]
        (crc,) = struct.unpack_from("<I", data, start + length)
        if _masked_crc(payload) != crc:
            raise ValueError(f"corrupt record CRC at byte {pos} of {path}")
        yield payload
        pos = start + length + 4


def read_scalars(logdir_or_file: str) -> Dict[str, List[Tuple[int, float]]]:
    """Parse scalar summaries from event file(s): tag -> [(step, value), ...].

    Dependency-free counterpart of the writer above (the TF-oracle suite
    cross-checks both against TF's own summary_iterator). A directory reads
    every ``events.out.tfevents.*`` file in filename order; image summaries
    (Summary.Value field 4) are skipped."""
    if os.path.isdir(logdir_or_file):
        files = sorted(
            os.path.join(logdir_or_file, n)
            for n in os.listdir(logdir_or_file)
            if n.startswith("events.out.tfevents")
        )
    else:
        files = [logdir_or_file]
    out: Dict[str, List[Tuple[int, float]]] = {}
    for path in files:
        for payload in iter_event_records(path):
            step = 0
            summary = None
            for field, wire, val in _iter_proto_fields(payload):
                if field == 2 and wire == 0:
                    step = val
                elif field == 5 and wire == 2:
                    summary = val
            if summary is None:
                continue
            for field, wire, val in _iter_proto_fields(summary):
                if field != 1 or wire != 2:
                    continue
                tag, simple = None, None
                for f2, w2, v2 in _iter_proto_fields(val):
                    if f2 == 1 and w2 == 2:
                        tag = v2.decode()
                    elif f2 == 2 and w2 == 5:  # simple_value (TF1-style — ours)
                        simple = struct.unpack("<f", struct.pack("<I", v2))[0]
                    elif f2 == 8 and w2 == 2:  # tensor (TF2 tf.summary.scalar)
                        simple = _scalar_from_tensor_proto(v2, simple)
                if tag is not None and simple is not None:
                    out.setdefault(tag, []).append((int(step), float(simple)))
    return out


def _scalar_from_tensor_proto(payload: bytes, default=None):
    """Extract a scalar float from a TensorProto (TF2 writers store scalars
    as DT_FLOAT tensors in Summary.Value.tensor instead of simple_value):
    dtype(1)=DT_FLOAT(1), value in float_val(5) or tensor_content(4)."""
    dtype = None
    fval = content = None
    for f, w, v in _iter_proto_fields(payload):
        if f == 1 and w == 0:
            dtype = v
        elif f == 5 and w == 5:  # float_val, unpacked
            fval = struct.unpack("<f", struct.pack("<I", v))[0]
        elif f == 5 and w == 2 and len(v) >= 4:  # float_val, packed
            fval = struct.unpack("<f", v[:4])[0]
        elif f == 4 and w == 2:  # tensor_content
            content = v
    if dtype != 1:  # not DT_FLOAT: leave whatever simple_value said
        return default
    if fval is not None:
        return fval
    if content is not None and len(content) >= 4:
        return struct.unpack("<f", content[:4])[0]
    return default

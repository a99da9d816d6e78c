"""Dependency-free TFRecord + tf.train.Example codec. A copy of the JAX
package's ``yoloret_tpu/data/tfrecord.py`` (host-only), with the CRC32C
always the table loop below: the JAX package's native library is not
part of the port.

The reference reads/writes TFRecords through the TensorFlow runtime
(reference: code/voc_annotation.py:31-68 writes Examples;
code/yolo3/data.py:32-55 and code/yolo3/map.py:34-53 parse them). This
framework has no TF dependency, so the container format (length-framed
records with masked CRC32C, the TFRecord wire format) and the protobuf
wire encoding of ``tf.train.Example`` are implemented directly. Feature
keys/types match the reference's schema so shards interoperate both
ways with TF tooling.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Union

FeatureValue = Union[bytes, str, List[float], List[int]]

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli) with TFRecord masking.
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Protobuf wire primitives (encode + decode).
# ---------------------------------------------------------------------------


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


def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


# ---------------------------------------------------------------------------
# tf.train.Example
# ---------------------------------------------------------------------------


class Example:
    """Minimal tf.train.Example: dict of str -> bytes | [float] | [int]."""

    def __init__(self, features: Dict[str, FeatureValue]):
        self.features = features

    def serialize(self) -> bytes:
        entries = b""
        for key, val in self.features.items():
            feature = self._encode_feature(val)
            entry = _len_delim(1, key.encode()) + _len_delim(2, feature)
            entries += _len_delim(1, entry)  # Features.feature map entry
        return _len_delim(1, entries)  # Example.features

    @staticmethod
    def _encode_feature(val: FeatureValue) -> bytes:
        if isinstance(val, str):
            val = val.encode()
        if isinstance(val, bytes):
            inner = _len_delim(1, val)  # BytesList.value
            return _len_delim(1, inner)  # Feature.bytes_list
        if not isinstance(val, (list, tuple)):
            raise TypeError(f"unsupported feature type {type(val)}")
        if val and isinstance(val[0], float) or all(isinstance(v, float) for v in val):
            payload = b"".join(struct.pack("<f", float(v)) for v in val)
            inner = _tag(1, 2) + _varint(len(payload)) + payload  # packed floats
            return _len_delim(2, inner)  # Feature.float_list
        payload = b"".join(_varint(int(v) & 0xFFFFFFFFFFFFFFFF) for v in val)
        inner = _tag(1, 2) + _varint(len(payload)) + payload  # packed int64
        return _len_delim(3, inner)  # Feature.int64_list

    @classmethod
    def parse(cls, data: bytes) -> "Example":
        feats: Dict[str, FeatureValue] = {}
        pos = 0
        while pos < len(data):
            tag, pos = _read_varint(data, pos)
            if tag >> 3 == 1 and tag & 7 == 2:  # Example.features
                ln, pos = _read_varint(data, pos)
                cls._parse_features(data[pos : pos + ln], feats)
                pos += ln
            else:
                pos = _skip(data, pos, tag & 7)
        return cls(feats)

    @classmethod
    def _parse_features(cls, data: bytes, out: Dict[str, FeatureValue]):
        pos = 0
        while pos < len(data):
            tag, pos = _read_varint(data, pos)
            if tag >> 3 == 1 and tag & 7 == 2:  # map entry
                ln, pos = _read_varint(data, pos)
                entry = data[pos : pos + ln]
                pos += ln
                key, val = cls._parse_entry(entry)
                out[key] = val
            else:
                pos = _skip(data, pos, tag & 7)

    @classmethod
    def _parse_entry(cls, data: bytes):
        key = ""
        val: FeatureValue = b""
        pos = 0
        while pos < len(data):
            tag, pos = _read_varint(data, pos)
            f, w = tag >> 3, tag & 7
            if f == 1 and w == 2:
                ln, pos = _read_varint(data, pos)
                key = data[pos : pos + ln].decode()
                pos += ln
            elif f == 2 and w == 2:
                ln, pos = _read_varint(data, pos)
                val = cls._parse_feature(data[pos : pos + ln])
                pos += ln
            else:
                pos = _skip(data, pos, w)
        return key, val

    @staticmethod
    def _parse_feature(data: bytes) -> FeatureValue:
        pos = 0
        while pos < len(data):
            tag, pos = _read_varint(data, pos)
            f, w = tag >> 3, tag & 7
            ln, pos = _read_varint(data, pos)
            body = data[pos : pos + ln]
            pos += ln
            if f == 1:  # bytes_list
                # BytesList: repeated bytes value = 1
                p2 = 0
                vals = []
                while p2 < len(body):
                    t2, p2 = _read_varint(body, p2)
                    l2, p2 = _read_varint(body, p2)
                    vals.append(body[p2 : p2 + l2])
                    p2 += l2
                return vals[0] if len(vals) == 1 else vals
            if f == 2:  # float_list (packed or repeated)
                p2 = 0
                vals_f: List[float] = []
                while p2 < len(body):
                    t2, p2 = _read_varint(body, p2)
                    if t2 & 7 == 2:
                        l2, p2 = _read_varint(body, p2)
                        for off in range(0, l2, 4):
                            vals_f.append(struct.unpack_from("<f", body, p2 + off)[0])
                        p2 += l2
                    else:  # wire 5: single fixed32
                        vals_f.append(struct.unpack_from("<f", body, p2)[0])
                        p2 += 4
                return vals_f
            if f == 3:  # int64_list
                p2 = 0
                vals_i: List[int] = []
                while p2 < len(body):
                    t2, p2 = _read_varint(body, p2)
                    if t2 & 7 == 2:
                        l2, p2 = _read_varint(body, p2)
                        end = p2 + l2
                        while p2 < end:
                            v, p2 = _read_varint(body, p2)
                            vals_i.append(v)
                    else:
                        v, p2 = _read_varint(body, p2)
                        vals_i.append(v)
                return vals_i
        return b""


def _skip(data: bytes, pos: int, wire: int) -> int:
    if wire == 0:
        _, pos = _read_varint(data, pos)
    elif wire == 1:
        pos += 8
    elif wire == 2:
        ln, pos = _read_varint(data, pos)
        pos += ln
    elif wire == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire}")
    return pos


# ---------------------------------------------------------------------------
# TFRecord container.
# ---------------------------------------------------------------------------


class TFRecordWriter:
    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, record: bytes):
        header = struct.pack("<Q", len(record))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc(header)))
        self._f.write(record)
        self._f.write(struct.pack("<I", masked_crc(record)))

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def index_tfrecord(path: str) -> List[tuple]:
    """[(offset, length)] of every record's payload — enables lazy
    random access for the input pipeline without loading shards in RAM."""
    out = []
    with open(path, "rb") as f:
        pos = 0
        while True:
            header = f.read(8)
            if len(header) < 8:
                return out
            (length,) = struct.unpack("<Q", header)
            f.read(4)
            out.append((pos + 12, length))
            f.seek(length + 4, 1)
            pos += 12 + length + 4


def read_record_at(path: str, offset: int, length: int) -> bytes:
    with open(path, "rb") as f:
        f.seek(offset)
        return f.read(length)


def read_tfrecords(path: str, verify: bool = True) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            if verify and masked_crc(header) != hcrc:
                raise IOError(f"corrupt TFRecord header in {path}")
            data = f.read(length)
            (dcrc,) = struct.unpack("<I", f.read(4))
            if verify and masked_crc(data) != dcrc:
                raise IOError(f"corrupt TFRecord data in {path}")
            yield data

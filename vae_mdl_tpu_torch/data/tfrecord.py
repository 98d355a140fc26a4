"""Pure-Python TFRecord and tf.train.Example reader, no TensorFlow.

A copy of ``vae_mdl_tpu/data/tfrecord.py`` (pure Python, kept here so the
port imports nothing of the JAX package). CelebA's Glow shards are TFRecord
files of serialized Examples; the framing is length-prefixed records and the
Example proto needs three wire types.

TFRecord framing (per record):
    uint64  length
    uint32  masked crc32c of length
    bytes   data[length]
    uint32  masked crc32c of data

Example proto: Example{ features: Features{ feature: map<string, Feature> } }
with Feature one of bytes_list / float_list / int64_list.
"""
from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Union

import numpy as np

FeatureValue = Union[List[bytes], np.ndarray]


_CRC32C_TABLE = None


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli, reflected 0x82F63B78) — the TFRecord checksum."""
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            table.append(c)
        _CRC32C_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC32C_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    """TFRecord's rotated+offset masking of crc32c (so CRCs of CRCs don't
    collide with data)."""
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def read_records(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    """Yield raw record payloads from one TFRecord file.

    ``verify_crc=True`` checks both masked-crc32c checksums (length and
    payload) and raises ``ValueError`` on corruption — pure Python, so it
    costs real time on large shards; leave off for trusted local files."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            data = f.read(length)
            data_crc = f.read(4)
            if len(data) < length:
                return
            if verify_crc:
                (want_len_crc,) = struct.unpack("<I", header[8:12])
                if masked_crc(header[:8]) != want_len_crc:
                    raise ValueError(
                        f"{path}: corrupt TFRecord length checksum")
                (want_data_crc,) = struct.unpack("<I", data_crc)
                if masked_crc(data) != want_data_crc:
                    raise ValueError(
                        f"{path}: corrupt TFRecord payload checksum")
            yield data


# --- minimal protobuf wire-format decoding ------------------------------------

def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:  # varint
        _, pos = _read_varint(buf, pos)
    elif wire_type == 1:  # fixed64
        pos += 8
    elif wire_type == 2:  # length-delimited
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wire_type == 5:  # fixed32
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire_type}")
    return pos


def _iter_fields(buf: bytes):
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire_type = tag >> 3, tag & 7
        if wire_type == 2:
            length, pos = _read_varint(buf, pos)
            yield field, buf[pos:pos + length]
            pos += length
        elif wire_type == 0:
            value, pos = _read_varint(buf, pos)
            yield field, value
        elif wire_type == 5:
            # fixed32 — how UNPACKED repeated floats arrive (parsers must
            # accept both packed and unpacked encodings); yielded as the
            # raw 4 bytes so the FloatList branch decodes it like a packed
            # run of length one
            yield field, buf[pos:pos + 4]
            pos += 4
        else:
            pos = _skip_field(buf, pos, wire_type)


def _parse_feature(buf: bytes) -> FeatureValue:
    """Feature: field 1 BytesList, 2 FloatList, 3 Int64List."""
    for field, value in _iter_fields(buf):
        if field == 1:  # BytesList{ repeated bytes value = 1 }
            return [v for f, v in _iter_fields(value) if f == 1]
        if field == 2:  # FloatList{ repeated float value = 1 } — packed
            # runs arrive length-delimited, unpacked values as fixed32;
            # both reach here as byte strings of 4n floats
            floats: List[float] = []
            for f, v in _iter_fields(value):
                if f == 1 and isinstance(v, bytes):
                    floats.extend(struct.unpack(f"<{len(v) // 4}f", v))
            return np.asarray(floats, dtype=np.float32)
        if field == 3:  # Int64List{ repeated int64 value = 1 [packed] }
            ints: List[int] = []
            for f, v in _iter_fields(value):
                if f == 1 and isinstance(v, bytes):
                    p = 0
                    while p < len(v):
                        i, p = _read_varint(v, p)
                        ints.append(i)
                elif f == 1:
                    ints.append(v)
            return np.asarray(ints, dtype=np.int64)
    return []


def parse_example(record: bytes) -> Dict[str, FeatureValue]:
    """Decode one serialized tf.train.Example into {name: value}."""
    out: Dict[str, FeatureValue] = {}
    for field, features_buf in _iter_fields(record):
        if field != 1:  # Example.features
            continue
        for ffield, entry in _iter_fields(features_buf):
            if ffield != 1:  # Features.feature (map entry)
                continue
            name = None
            value: FeatureValue = []
            for mfield, mval in _iter_fields(entry):
                if mfield == 1:
                    name = mval.decode()
                elif mfield == 2:
                    value = _parse_feature(mval)
            if name is not None:
                out[name] = value
    return out

"""Self-contained TFRecord + tf.train.Example codec (no TensorFlow).

The port's own copy of ``satellite_computervision_tpu/data/tfrecord.py``
(numpy only; its native fast path is the port's ``native`` package).

Reads and writes the GZIP TFRecord files Earth Engine exports and ingests
(reference: tf.data.TFRecordDataset(..., 'GZIP') at utils/processing.py:416
and the prediction writer at utils/prediction_tools.py:375-445). Implements:

- TFRecord framing: [uint64 length][masked crc32c(length)][payload]
  [masked crc32c(payload)]
- the protobuf wire format for Example/Features/Feature with float, int64
  and bytes lists (packed and unpacked encodings)
- CRC32C (Castagnoli) with the TFRecord mask.

A C++ fast path (the port's native/fastrecord) serves bulk decode; this
pure-Python module is the always-available reference implementation, with
NumPy doing the heavy lifting (float payloads decode via frombuffer).
"""

from __future__ import annotations

import gzip
import io
import struct
from typing import Dict, Iterator, List, Optional, Union

import numpy as np

# ---------------------------------------------------------------------------
# CRC32C
# ---------------------------------------------------------------------------

_CRC_TABLE = None


def _crc32c_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78  # reflected Castagnoli
        table = np.zeros(256, np.uint32)
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
            table[i] = crc
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    from satellite_computervision_tpu_torch import native

    fast = native.crc32c(data)
    if fast is not None:
        return fast
    table = _crc32c_table()
    crc = np.uint32(0xFFFFFFFF)
    # Byte-at-a-time via the table; the C++ codec accelerates this path.
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> np.uint32(8))
    return int(crc ^ np.uint32(0xFFFFFFFF))


def masked_crc32c(data: bytes) -> int:
    from satellite_computervision_tpu_torch import native

    fast = native.masked_crc32c(data)
    if fast is not None:
        return fast
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Protobuf wire format primitives
# ---------------------------------------------------------------------------


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


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:
        _, pos = _read_varint(buf, pos)
    elif wire_type == 1:
        pos += 8
    elif wire_type == 2:
        size, pos = _read_varint(buf, pos)
        pos += size
    elif wire_type == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire_type}")
    return pos


def _iter_fields(buf: bytes):
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wire_type = tag >> 3, tag & 7
        yield field, wire_type, pos
        pos = _skip_field(buf, pos, wire_type)


def _delimited(buf: bytes, pos: int):
    size, pos = _read_varint(buf, pos)
    return buf[pos : pos + size]


# ---------------------------------------------------------------------------
# Example encode/decode
# ---------------------------------------------------------------------------

FeatureValue = Union[np.ndarray, List[bytes]]


def _parse_feature(buf: bytes) -> FeatureValue:
    for field, wire_type, pos in _iter_fields(buf):
        payload = _delimited(buf, pos)
        if field == 1:  # BytesList
            out = []
            for f2, _, p2 in _iter_fields(payload):
                if f2 == 1:
                    out.append(bytes(_delimited(payload, p2)))
            return out
        if field == 2:  # FloatList
            values = []
            for f2, wt2, p2 in _iter_fields(payload):
                if f2 != 1:
                    continue
                if wt2 == 2:  # packed
                    raw = _delimited(payload, p2)
                    values.append(np.frombuffer(raw, "<f4"))
                elif wt2 == 5:  # unpacked single float
                    values.append(np.frombuffer(payload[p2 : p2 + 4], "<f4"))
            return np.concatenate(values) if values else np.zeros(0, np.float32)
        if field == 3:  # Int64List
            values = []
            for f2, wt2, p2 in _iter_fields(payload):
                if f2 != 1:
                    continue
                if wt2 == 2:  # packed varints
                    raw = _delimited(payload, p2)
                    rp = 0
                    while rp < len(raw):
                        v, rp = _read_varint(raw, rp)
                        if v >= 1 << 63:
                            v -= 1 << 64
                        values.append(v)
                elif wt2 == 0:
                    v, _ = _read_varint(payload, p2)
                    if v >= 1 << 63:
                        v -= 1 << 64
                    values.append(v)
            return np.asarray(values, np.int64)
    return np.zeros(0, np.float32)


def parse_example(buf: bytes) -> Dict[str, FeatureValue]:
    """Decode a serialized tf.train.Example into {name: ndarray | [bytes]}."""
    features: Dict[str, FeatureValue] = {}
    for field, _, pos in _iter_fields(buf):
        if field != 1:
            continue
        fmap = _delimited(buf, pos)  # Features message
        for f2, _, p2 in _iter_fields(fmap):
            if f2 != 1:
                continue
            entry = _delimited(fmap, p2)  # map<string, Feature> entry
            key, value = None, None
            for f3, _, p3 in _iter_fields(entry):
                if f3 == 1:
                    key = _delimited(entry, p3).decode("utf-8")
                elif f3 == 2:
                    value = _parse_feature(_delimited(entry, p3))
            if key is not None:
                features[key] = value
    return features


def _tag(field: int, wire_type: int) -> bytes:
    return _write_varint(field << 3 | wire_type)


def _len_delimited(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _write_varint(len(payload)) + payload


def _encode_feature(value) -> bytes:
    if isinstance(value, (list, tuple)) and value and isinstance(value[0], (bytes, bytearray)):
        inner = b"".join(_len_delimited(1, bytes(v)) for v in value)
        return _len_delimited(1, inner)
    arr = np.asarray(value)
    if np.issubdtype(arr.dtype, np.integer):
        payload = b"".join(
            _write_varint(int(v) & 0xFFFFFFFFFFFFFFFF) for v in arr.reshape(-1)
        )
        return _len_delimited(3, _len_delimited(1, payload))
    arr = arr.astype("<f4").reshape(-1)
    return _len_delimited(2, _len_delimited(1, arr.tobytes()))


def build_example(features: Dict[str, FeatureValue]) -> bytes:
    """Encode {name: array-like | [bytes]} as a serialized tf.train.Example."""
    entries = []
    for key, value in features.items():
        entry = _len_delimited(1, key.encode("utf-8")) + _len_delimited(
            2, _encode_feature(value)
        )
        entries.append(_len_delimited(1, entry))
    return _len_delimited(1, b"".join(entries))


# ---------------------------------------------------------------------------
# TFRecord framing
# ---------------------------------------------------------------------------


class TFRecordReader:
    """Iterate serialized records from a TFRecord stream (optionally GZIP)."""

    def __init__(self, path_or_file, compression: Optional[str] = "GZIP", verify_crc: bool = False):
        self._own = isinstance(path_or_file, (str, bytes))
        if self._own:
            raw = open(path_or_file, "rb")
        else:
            raw = path_or_file
        self._wrapped = compression == "GZIP"
        self._f = gzip.GzipFile(fileobj=raw) if self._wrapped else raw
        self._raw = raw
        self._verify = verify_crc

    def __iter__(self) -> Iterator[bytes]:
        while True:
            header = self._f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            if self._verify:
                (len_crc,) = struct.unpack("<I", header[8:12])
                if masked_crc32c(header[:8]) != len_crc:
                    raise IOError("TFRecord length CRC mismatch")
            payload = self._f.read(length)
            footer = self._f.read(4)
            if len(payload) < length or len(footer) < 4:
                raise IOError("truncated TFRecord")
            if self._verify:
                (data_crc,) = struct.unpack("<I", footer)
                if masked_crc32c(payload) != data_crc:
                    raise IOError("TFRecord payload CRC mismatch")
            yield payload

    def close(self):
        if self._wrapped:
            self._f.close()
        if self._own:
            self._raw.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TFRecordWriter:
    def __init__(self, path_or_file, compression: Optional[str] = "GZIP"):
        self._own = isinstance(path_or_file, (str, bytes))
        raw = open(path_or_file, "wb") if self._own else path_or_file
        self._wrapped = compression == "GZIP"
        self._f = gzip.GzipFile(fileobj=raw, mode="wb") if self._wrapped else raw
        self._raw = raw

    def write(self, record: bytes):
        header = struct.pack("<Q", len(record))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc32c(header)))
        self._f.write(record)
        self._f.write(struct.pack("<I", masked_crc32c(record)))

    def close(self):
        # Close only what this writer created: the gzip wrapper and/or a
        # file it opened; caller-provided streams stay open.
        if self._wrapped:
            self._f.close()
        if self._own:
            self._raw.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_tfrecord_file(
    path: str, compression: Optional[str] = "GZIP", verify_crc: bool = False
) -> List[Dict[str, FeatureValue]]:
    """Parse every Example in a TFRecord file."""
    with TFRecordReader(path, compression, verify_crc) as reader:
        return [parse_example(rec) for rec in reader]


def write_tfrecord_file(
    path: str, examples, compression: Optional[str] = "GZIP"
) -> None:
    """Write an iterable of {name: value} feature dicts as Examples."""
    with TFRecordWriter(path, compression) as writer:
        for ex in examples:
            writer.write(build_example(ex))


def read_float_examples(
    path: str,
    names,
    compression: Optional[str] = "GZIP",
    verify_crc: bool = False,
):
    """Bulk fast path: decode every Example's named packed-float features.

    Uses the C++ codec (native.fastrecord) for framing + feature location
    when available; falls back to the pure-Python parser. Returns a list of
    {name: float32 ndarray} dicts.
    """
    from satellite_computervision_tpu_torch import native

    with open(path, "rb") as f:
        blob = f.read()
    if compression == "GZIP":
        blob = gzip.decompress(blob)

    split = native.split_records(blob, verify=verify_crc)
    if split is None:  # no native library: pure-Python route
        out = []
        reader = TFRecordReader(io.BytesIO(blob), compression=None, verify_crc=verify_crc)
        for rec in reader:
            parsed = parse_example(rec)
            out.append({n: np.asarray(parsed[n], np.float32) for n in names})
        return out

    offsets, lengths = split
    out = []
    for off, ln in zip(offsets, lengths):
        rec = blob[off : off + ln]
        row = {}
        for n in names:
            arr = native.find_float_feature(rec, n)
            if arr is None:  # unpacked or missing: slow-path this record
                parsed = parse_example(rec)
                arr = np.asarray(parsed[n], np.float32)
            row[n] = arr
        out.append(row)
    return out


def roundtrip_bytes(examples, compression=None) -> bytes:
    """Serialize examples to an in-memory TFRecord blob (fixtures/tests)."""
    bio = io.BytesIO()
    with TFRecordWriter(bio, compression) as writer:
        for ex in examples:
            writer.write(build_example(ex))
    return bio.getvalue()

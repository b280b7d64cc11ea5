"""A reader of flax's msgpack checkpoints that needs no ``msgpack`` package.

``flax.serialization.to_bytes`` writes a state tree as msgpack: nested
maps with string keys (tuples and lists become maps with keys ``"0"``,
``"1"``, ...), Python ints/floats/bools/None, and arrays as ext
type 1 (numpy scalars as ext type 3) whose payload is itself msgpack of
``(shape, dtype name, raw C-order bytes)``. :func:`restore` decodes the
same tree as ``flax.serialization.msgpack_restore``, with these explicit
choices:

- arrays are read-only numpy views of the input bytes (no copy); a
  msgpack array decodes as a list;
- a ``bfloat16`` array (numpy has no such dtype) becomes float32, exactly:
  every bfloat16 value is a float32 value;
- an array flax split into chunks (leaves over 2**30 bytes) raises
  ``ValueError``; so do the complex-number ext type 2, any other ext type
  and malformed or trailing bytes.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Decoder:
    """``views``: bin objects come back as memoryviews of the input (used
    for array payloads, so arrays need no copy), else as bytes."""

    def __init__(self, data, views: bool = False):
        self.buf = memoryview(data).cast("B")
        self.pos = 0
        self.views = views

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        if _CHUNKED in out:
            raise ValueError(
                "chunked array (a leaf over 2**30 bytes, split by flax) is not supported")
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = self.take(n)
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            arr = _ndarray(payload)
            return arr if code == _EXT_NDARRAY else arr[()]
        if code == _EXT_COMPLEX:
            raise ValueError("complex-number leaves (msgpack ext type 2) are not supported")
        raise ValueError(f"unknown msgpack ext type {code}")

    def read(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        sized = {  # marker -> (length format, kind)
            0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
            0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
            0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"),
            0xDE: (">H", "map"), 0xDF: (">I", "map"),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n) if self.views else bytes(self.take(n))
            return getattr(self, kind)(n)
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"invalid msgpack marker 0x{b:02x}")


def _ndarray(payload: memoryview) -> np.ndarray:
    dec = _Decoder(payload, views=True)
    shape, dtype_name, raw = dec.read()
    if dec.pos != len(dec.buf):
        raise ValueError("trailing bytes in an array payload")
    shape = tuple(shape)
    if dtype_name == "bfloat16":
        bits = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(raw, np.dtype(dtype_name)).reshape(shape)


def restore(data: bytes) -> Any:
    """Decode one msgpack-serialized flax state tree (see the module
    docstring for what is supported)."""
    dec = _Decoder(data)
    tree = dec.read()
    if dec.pos != len(dec.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return tree

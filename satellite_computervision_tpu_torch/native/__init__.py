"""Native (C++) host-side codec with ctypes bindings: the port's own copy of
``satellite_computervision_tpu/native``.

``fastrecord.cc`` holds the TFRecord CRC32C, record framing, packed-float
feature location and TIFF LZW. It is host code, not a device kernel: it
keeps chip ingestion (``data/tfrecord.py``) from spending seconds per chip
in a pure-Python CRC. The library is compiled with the system ``g++`` at
first use into ``build/native/`` at the repository root (never into the
package directory); its file name carries a hash of the source and flags,
so an edited source is rebuilt. Without a compiler every function returns
``None`` and callers take the pure-Python route. The C calls release the
GIL, so ``data.pipeline.ChipDataset(workers=N)`` decodes files concurrently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "fastrecord.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    """Where ``fastrecord.cc`` builds to (content-addressed)."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libfastrecord-{digest.hexdigest()[:16]}.so"


def build() -> Optional[Path]:
    """Compile the codec (if not built yet); None when ``g++`` is missing
    or fails. The temporary output is renamed into place, so concurrent
    builders never load a half-written library."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", tmp], check=True,
                       capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        os.unlink(tmp)
        return None
    os.replace(tmp, out)
    return out


def get_lib():
    """The loaded fastrecord library, building it on first use; None when
    unavailable (callers fall back to pure Python)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.scv_crc32c.argtypes = [u8p, ctypes.c_int64]
        lib.scv_crc32c.restype = ctypes.c_uint32
        lib.scv_masked_crc32c.argtypes = [u8p, ctypes.c_int64]
        lib.scv_masked_crc32c.restype = ctypes.c_uint32
        lib.scv_split_records.argtypes = [u8p, ctypes.c_int64, ctypes.c_int, i64p, i64p, ctypes.c_int64]
        lib.scv_split_records.restype = ctypes.c_int64
        lib.scv_find_float_feature.argtypes = [u8p, ctypes.c_int64, ctypes.c_char_p, i64p]
        lib.scv_find_float_feature.restype = ctypes.c_int64
        lib.scv_frame_record.argtypes = [u8p, ctypes.c_int64, u8p]
        lib.scv_frame_record.restype = ctypes.c_int64
        lib.scv_lzw_encode.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64]
        lib.scv_lzw_encode.restype = ctypes.c_int64
        lib.scv_lzw_decode.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64]
        lib.scv_lzw_decode.restype = ctypes.c_int64
        _lib = lib
        return _lib


def _as_u8(buf) -> ctypes.Array:
    return (ctypes.c_uint8 * len(buf)).from_buffer_copy(buf)


def crc32c(data: bytes) -> Optional[int]:
    lib = get_lib()
    if lib is None:
        return None
    return int(lib.scv_crc32c(_as_u8(data), len(data)))


def masked_crc32c(data: bytes) -> Optional[int]:
    lib = get_lib()
    if lib is None:
        return None
    return int(lib.scv_masked_crc32c(_as_u8(data), len(data)))


def split_records(blob: bytes, verify: bool = False):
    """Record (offset, length) pairs of a decompressed TFRecord stream, or
    None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    max_records = max(16, len(blob) // 28)  # framing floor: 16B overhead + payload
    offsets = np.zeros(max_records, np.int64)
    lengths = np.zeros(max_records, np.int64)
    buf = _as_u8(blob)
    n = lib.scv_split_records(
        buf,
        len(blob),
        1 if verify else 0,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        max_records,
    )
    if n == -2:
        raise IOError("TFRecord CRC mismatch")
    if n < 0:
        raise IOError("truncated/corrupt TFRecord stream")
    return offsets[:n], lengths[:n]


def find_float_feature(example: bytes, name: str) -> Optional[np.ndarray]:
    """Zero-parse extraction of a packed FloatList feature as float32."""
    lib = get_lib()
    if lib is None:
        return None
    out_len = ctypes.c_int64(0)
    off = lib.scv_find_float_feature(
        _as_u8(example), len(example), name.encode("utf-8"), ctypes.byref(out_len)
    )
    if off < 0:
        return None
    return np.frombuffer(example, "<f4", count=out_len.value // 4, offset=off).copy()


def frame_record(payload: bytes) -> Optional[bytes]:
    """TFRecord framing (header/CRCs/footer) around a serialized Example."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.zeros(len(payload) + 16, np.uint8)
    n = lib.scv_frame_record(
        _as_u8(payload), len(payload), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    )
    return out[:n].tobytes()


def lzw_encode(data: bytes) -> Optional[bytes]:
    """TIFF-flavor LZW encode (compression 5, early change), or None when
    the native library is unavailable. The worst case for LZW is ~9/8
    expansion on incompressible input plus clear/EOI overhead."""
    lib = get_lib()
    if lib is None:
        return None
    cap = len(data) + len(data) // 2 + 64
    out = np.zeros(cap, np.uint8)
    n = lib.scv_lzw_encode(
        _as_u8(data), len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n < 0:
        return None  # caller falls back to pure Python
    return out[:n].tobytes()


def lzw_decode(data: bytes, decoded_size: int) -> Optional[bytes]:
    """TIFF-flavor LZW decode into a buffer of ``decoded_size`` (the TIFF
    chunk geometry fixes it); None when the library is unavailable.
    Raises ValueError on a corrupt stream, matching the Python decoder."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.zeros(max(decoded_size, 1), np.uint8)
    n = lib.scv_lzw_decode(
        _as_u8(data), len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), decoded_size)
    if n == -1:
        raise ValueError("corrupt LZW stream")
    if n < 0:
        return None  # undersized buffer estimate: fall back
    return out[:n].tobytes()

"""Minimal-but-real GeoTIFF / Cloud-Optimized GeoTIFF codec in pure Python.

rasterio and GDAL are not available in this environment, so the writers the
reference delegates to them (numpy_to_raster / arrays_to_cog,
utils/raster_tools.py:367-461; rio.open GTiff writes,
utils/prediction_tools.py:447-536) are implemented directly against the
TIFF 6.0 + GeoTIFF 1.1 specs:

- classic little-endian TIFF, striped or tiled layout (BigTIFF — version
  43, 64-bit offsets — when the raster would overflow classic TIFF's
  4 GiB offsets, or on request via ``bigtiff=True``),
- float32/float64/uint8/uint16/int16/int32 samples, pixel-interleaved,
- DEFLATE (zlib) and LZW (compression 5, early-change variant, GDAL's
  common COG recipe) compression with TIFF predictor 2 (integer
  horizontal differencing) / predictor 3 (floating-point byte-plane
  differencing) on write — the LZW hot loops run in the native module
  (native/fastrecord.cc) with a bit-identical pure-Python fallback,
- georeferencing via ModelPixelScale + ModelTiepoint (or a full
  ModelTransformation when the affine has shear), GeoKey directory with
  EPSG projected/geographic CRS codes, GDAL_NODATA,
- COG writer: 256x256 tiles + power-of-two mean-pooled overview IFDs.

The reader parses the same subset back, plus PackBits (32773) chunks —
so real-world COG assets (NAIP / Sentinel-2 on the Planetary Computer,
the reference's inputs via rasterio) decode here without GDAL, and
files written here with 'lzw'+predictor read back through the very same
decode table.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence

import numpy as np

# TIFF tag ids
_IMAGE_WIDTH = 256
_IMAGE_LENGTH = 257
_BITS_PER_SAMPLE = 258
_COMPRESSION = 259
_PHOTOMETRIC = 262
_STRIP_OFFSETS = 273
_SAMPLES_PER_PIXEL = 277
_ROWS_PER_STRIP = 278
_STRIP_BYTE_COUNTS = 279
_PLANAR_CONFIG = 284
_NEW_SUBFILE_TYPE = 254
_TILE_WIDTH = 322
_TILE_LENGTH = 323
_TILE_OFFSETS = 324
_TILE_BYTE_COUNTS = 325
_SAMPLE_FORMAT = 339
_PREDICTOR = 317
_MODEL_PIXEL_SCALE = 33550
_MODEL_TIEPOINT = 33922
_MODEL_TRANSFORMATION = 34264
_GEO_KEY_DIRECTORY = 34735
_GEO_ASCII_PARAMS = 34737
_GDAL_NODATA = 42113

_TYPE_SHORT = 3
_TYPE_LONG = 4
_TYPE_ASCII = 2
_TYPE_DOUBLE = 12
_TYPE_LONG8 = 16  # BigTIFF 64-bit unsigned

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
               10: 8, 11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}

# last classic-TIFF offset a chunk may start at (IFD + outline follow)
_CLASSIC_LIMIT = 0xFFFF0000


def _auto_bigtiff(height, width, channels, itemsize, tile_size=None,
                  overviews=False, expand: float = 1.0) -> bool:
    """Conservative pre-write estimate of whether a raster needs 64-bit
    offsets: padded-tile payload (+1/3 for an overview pyramid) PLUS the
    IFD's out-of-line strip/tile offset+byte-count arrays (8 B per chunk
    classic — at 4 GiB of 8 KiB strips that is ~4 MiB, enough to push a
    near-limit file's outline pointers past 2^32) vs the classic limit.
    DEFLATE only shrinks payloads by more than the per-chunk overhead, so
    its uncompressed-size estimate is safe — but LZW can EXPAND
    high-entropy data up to ~1.5x (12-bit codes per literal byte), so
    LZW callers pass ``expand`` to keep the estimate conservative."""
    if tile_size:
        h = -(-height // tile_size) * tile_size
        w = -(-width // tile_size) * tile_size
        n_chunks = (h // tile_size) * (w // tile_size)
    else:
        h, w = height, width
        rps = _default_rows_per_strip(width, channels, itemsize)
        n_chunks = -(-height // rps)
    est = int(h * w * channels * itemsize * expand) + n_chunks * 16
    if overviews:
        est += est // 3
    return est > _CLASSIC_LIMIT - (1 << 20)


def _auto_expand(comp_code: int) -> float:
    """Worst-case payload growth for _auto_bigtiff: LZW's 12-bit-code
    ceiling on incompressible input, 1.0 for none/DEFLATE."""
    return 1.5 if comp_code == _COMP_LZW else 1.0

_SAMPLE_FORMATS = {
    np.dtype("uint8"): 1,
    np.dtype("uint16"): 1,
    np.dtype("uint32"): 1,
    np.dtype("int16"): 2,
    np.dtype("int32"): 2,
    np.dtype("float32"): 3,
    np.dtype("float64"): 3,
}


def _epsg_from_crs(crs: str) -> Optional[int]:
    if not crs:
        return None
    crs = crs.strip().upper()
    if crs.startswith("EPSG:"):
        return int(crs.split(":")[1])
    if crs.isdigit():
        return int(crs)
    return None


def _geokeys(crs: str):
    """Build the GeoKeyDirectory shorts + ascii params for a CRS string."""
    epsg = _epsg_from_crs(crs)
    keys = []  # (key, tag_location, count, value)
    ascii_params = (crs + "|") if crs else ""
    if epsg is None:
        model_type = 0
    elif 4000 <= epsg < 5000:  # geographic
        model_type = 2
        keys.append((2048, 0, 1, epsg))
    else:  # projected
        model_type = 1
        keys.append((3072, 0, 1, epsg))
    header_keys = [(1024, 0, 1, model_type), (1025, 0, 1, 1)]  # area pixels
    if ascii_params:
        header_keys.append((1026, _GEO_ASCII_PARAMS, len(ascii_params), 0))
    all_keys = header_keys + keys
    directory = [1, 1, 1, len(all_keys)]
    for k in sorted(all_keys):
        directory.extend(k)
    return directory, ascii_params


def _header_bytes(big: bool, ifd_offset: int) -> bytes:
    """The file header; patch the IFD pointer later at _ptr_patch(big)."""
    if big:
        return b"II+\x00" + struct.pack("<HHQ", 8, 0, ifd_offset)
    return b"II*\x00" + struct.pack("<I", ifd_offset)


def _ptr_patch(big: bool):
    """(seek position, struct format) of the first-IFD pointer."""
    return (8, "<Q") if big else (4, "<I")


def _off_type(big: bool) -> int:
    """Tag type for strip/tile offset + byte-count arrays."""
    return _TYPE_LONG8 if big else _TYPE_LONG


class _IFDBuilder:
    """Accumulates (tag, type, values) entries and out-of-line data.
    ``big=True`` emits the BigTIFF directory layout (8-byte entry count,
    20-byte entries with 8-byte inline values, 8-byte next pointer)."""

    def __init__(self, big: bool = False):
        self.big = big
        self.entries = []

    def add(self, tag, type_, values):
        if isinstance(values, (int, float)):
            values = [values]
        self.entries.append((tag, type_, values))

    def add_ascii(self, tag, text: str):
        data = text.encode("ascii") + b"\x00"
        self.entries.append((tag, _TYPE_ASCII, data))

    def serialize(self, ifd_offset: int, next_ifd: int = 0):
        """Return (ifd_bytes, outline_bytes); outline data is placed
        immediately after the IFD."""
        n = len(self.entries)
        if self.big:
            entry_size, inline, cnt_fmt, off_fmt = 20, 8, "<Q", "<Q"
        else:
            entry_size, inline, cnt_fmt, off_fmt = 12, 4, "<I", "<I"
        head_size = 8 if self.big else 2
        outline_offset = (ifd_offset + head_size + n * entry_size
                          + struct.calcsize(off_fmt))
        ifd = struct.pack("<Q" if self.big else "<H", n)
        outline = b""
        fmt = {_TYPE_SHORT: "<H", _TYPE_LONG: "<I", _TYPE_DOUBLE: "<d",
               11: "<f", _TYPE_LONG8: "<Q"}
        for tag, type_, values in sorted(self.entries):
            if type_ == _TYPE_ASCII:
                raw = bytes(values)
                count = len(raw)
            else:
                raw = b"".join(struct.pack(fmt[type_], v) for v in values)
                count = len(values)
            if len(raw) <= inline:
                value_field = raw + b"\x00" * (inline - len(raw))
            else:
                value_field = struct.pack(off_fmt, outline_offset + len(outline))
                outline += raw
                if len(outline) % 2:
                    outline += b"\x00"
            ifd += struct.pack("<HH", tag, type_)
            ifd += struct.pack(cnt_fmt, count) + value_field
        ifd += struct.pack(off_fmt, next_ifd)
        return ifd, outline


def _base_tags(b, h, w, c, dtype, compress, transform, crs, nodata,
               subfile_type=None, predictor: int = 1):
    """Add the geometry/sample/geo tags shared by every page layout.
    ``compress`` is a normalized TIFF compression code (or a bool for the
    legacy callers)."""
    bits = dtype.itemsize * 8
    sample_format = _SAMPLE_FORMATS[dtype]
    if subfile_type is not None:
        b.add(_NEW_SUBFILE_TYPE, _TYPE_LONG, subfile_type)
    b.add(_IMAGE_WIDTH, _TYPE_LONG, w)
    b.add(_IMAGE_LENGTH, _TYPE_LONG, h)
    b.add(_BITS_PER_SAMPLE, _TYPE_SHORT, [bits] * c)
    b.add(_COMPRESSION, _TYPE_SHORT, _norm_compress(compress)
          if isinstance(compress, (bool, str, type(None))) else compress)
    b.add(_PHOTOMETRIC, _TYPE_SHORT, 1)
    b.add(_SAMPLES_PER_PIXEL, _TYPE_SHORT, c)
    b.add(_PLANAR_CONFIG, _TYPE_SHORT, 1)
    b.add(_SAMPLE_FORMAT, _TYPE_SHORT, [sample_format] * c)
    if predictor != 1:
        b.add(_PREDICTOR, _TYPE_SHORT, predictor)
    if transform is not None:
        a, bshear, tx, dshear, e, ty = transform
        if bshear == 0 and dshear == 0:
            b.add(_MODEL_PIXEL_SCALE, _TYPE_DOUBLE, [a, abs(e), 0.0])
            b.add(_MODEL_TIEPOINT, _TYPE_DOUBLE, [0, 0, 0, tx, ty, 0])
        else:
            b.add(
                _MODEL_TRANSFORMATION,
                _TYPE_DOUBLE,
                [a, bshear, 0, tx, dshear, e, 0, ty, 0, 0, 0, 0, 0, 0, 0, 1],
            )
    if crs or transform is not None:
        directory, ascii_params = _geokeys(crs)
        b.add(_GEO_KEY_DIRECTORY, _TYPE_SHORT, directory)
        if ascii_params:
            b.add_ascii(_GEO_ASCII_PARAMS, ascii_params)
    if nodata is not None:
        b.add_ascii(_GDAL_NODATA, str(nodata))


def _default_rows_per_strip(w, c, itemsize):
    return max(1, 8192 // max(1, w * c * itemsize))


def _page_ifd(
    image: np.ndarray,
    data_offset: int,
    ifd_offset: int,
    transform: Optional[Sequence[float]],
    crs: str,
    nodata,
    compress,
    tile_size: Optional[int],
    subfile_type: Optional[int] = None,
    big: bool = False,
    predictor: int = 1,
):
    """Build one TIFF page (IFD + pixel data) for an (H, W, C) array."""
    h, w, c = image.shape
    dtype = image.dtype
    comp_code = _norm_compress(compress)

    chunks = []
    if tile_size:
        ts = tile_size
        for ty in range(0, h, ts):
            for tx in range(0, w, ts):
                tile = np.zeros((ts, ts, c), dtype)
                sub = image[ty : ty + ts, tx : tx + ts]
                tile[: sub.shape[0], : sub.shape[1]] = sub
                chunks.append(_encode_chunk(tile, comp_code, predictor))
    else:
        rows_per_strip = _default_rows_per_strip(w, c, dtype.itemsize)
        for y in range(0, h, rows_per_strip):
            chunks.append(_encode_chunk(image[y : y + rows_per_strip],
                                        comp_code, predictor))

    offsets, counts = [], []
    pos = data_offset
    for chunk in chunks:
        offsets.append(pos)
        counts.append(len(chunk))
        pos += len(chunk) + (len(chunk) % 2)

    b = _IFDBuilder(big)
    _base_tags(b, h, w, c, dtype, comp_code, transform, crs, nodata,
               subfile_type, predictor=predictor)
    off_t = _off_type(big)
    if tile_size:
        b.add(_TILE_WIDTH, _TYPE_LONG, tile_size)
        b.add(_TILE_LENGTH, _TYPE_LONG, tile_size)
        b.add(_TILE_OFFSETS, off_t, offsets)
        b.add(_TILE_BYTE_COUNTS, off_t, counts)
    else:
        b.add(_ROWS_PER_STRIP, _TYPE_LONG, rows_per_strip)
        b.add(_STRIP_OFFSETS, off_t, offsets)
        b.add(_STRIP_BYTE_COUNTS, off_t, counts)

    return b, chunks, offsets, counts


def _write_pages(path, pages, big: bool = False, predictor: int = 1):
    """pages: list of (image, transform, crs, nodata, compress, tile_size,
    subfile_type)."""
    with open(path, "wb") as f:
        pos = len(_header_bytes(big, 0))
        f.write(_header_bytes(big, pos))
        for i, (image, transform, crs, nodata, compress, tile_size, subfile) in enumerate(
            pages
        ):
            # Two-pass per page: measure IFD size, then emit IFD + data.
            probe, _, _, _ = _page_ifd(
                image, 0, pos, transform, crs, nodata, compress, tile_size,
                subfile, big, predictor
            )
            probe_bytes, probe_outline = probe.serialize(pos)
            data_offset = pos + len(probe_bytes) + len(probe_outline)
            builder, chunks, offsets, _ = _page_ifd(
                image, data_offset, pos, transform, crs, nodata, compress,
                tile_size, subfile, big, predictor
            )
            data_size = (offsets[-1] + len(chunks[-1]) + (len(chunks[-1]) % 2)) - data_offset
            next_ifd = 0 if i == len(pages) - 1 else data_offset + data_size
            ifd_bytes, outline = builder.serialize(pos, next_ifd)
            assert len(ifd_bytes) == len(probe_bytes) and len(outline) == len(probe_outline)
            f.write(ifd_bytes)
            f.write(outline)
            for chunk in chunks:
                f.write(chunk)
                if len(chunk) % 2:
                    f.write(b"\x00")
            pos = next_ifd


# ---------------------------------------------------------------------------
# Chunk encode/decode: compression codes 1 (none) / 5 (LZW) / 8 (DEFLATE)
# with TIFF predictors 1/2/3 — shared by the one-shot writers, the
# streaming writers and the windowed reader, so every write is readable
# back through the same table.
# ---------------------------------------------------------------------------

_COMP_NONE, _COMP_LZW, _COMP_DEFLATE = 1, 5, 8
_COMPRESS_NAMES = {
    None: _COMP_NONE, False: _COMP_NONE, "none": _COMP_NONE,
    True: _COMP_DEFLATE, "deflate": _COMP_DEFLATE, "zlib": _COMP_DEFLATE,
    "lzw": _COMP_LZW,
}


def _norm_compress(compress) -> int:
    """Normalize the writers' ``compress`` argument (bool for back-compat,
    'none'/'deflate'/'lzw', or an already-normalized TIFF code) to the
    TIFF compression code. Integer codes are checked BEFORE the name
    table: hash(1) == hash(True), so a plain dict lookup would silently
    turn code 1 ('no compression') into DEFLATE."""
    if isinstance(compress, int) and not isinstance(compress, bool):
        if compress in (_COMP_NONE, _COMP_LZW, _COMP_DEFLATE):
            return compress
        raise ValueError(f"unsupported TIFF compression code {compress}")
    key = compress.lower() if isinstance(compress, str) else compress
    if key not in _COMPRESS_NAMES:
        raise ValueError(
            f"unsupported compression {compress!r}; use False/'none', "
            "True/'deflate', or 'lzw'")
    return _COMPRESS_NAMES[key]


def _check_predictor(predictor: int, dtype) -> int:
    if predictor not in (1, 2, 3):
        raise ValueError(f"unsupported TIFF predictor {predictor}")
    dtype = np.dtype(dtype)
    if predictor == 2 and dtype.kind not in "ui":
        raise ValueError("predictor 2 requires integer samples")
    if predictor == 3 and dtype.kind != "f":
        raise ValueError("predictor 3 requires floating-point samples")
    return predictor


def _apply_predictor(arr: np.ndarray, predictor: int) -> bytes:
    """Forward TIFF predictor over one (rows, width, channels) chunk —
    the exact inverse of :func:`_undo_predictor`."""
    if predictor == 2:
        u = np.ascontiguousarray(arr).view(
            np.dtype(f"u{arr.dtype.itemsize}"))
        d = u.copy()
        d[:, 1:] -= u[:, :-1]
        return d.tobytes()
    if predictor == 3:
        rows, width, channels = arr.shape
        it = arr.dtype.itemsize
        be = np.ascontiguousarray(arr).astype(
            np.dtype(arr.dtype.str.replace("<", ">")))
        planes = be.view(np.uint8).reshape(rows, width * channels, it)
        b = np.ascontiguousarray(planes.transpose(0, 2, 1)).reshape(
            rows, it * width, channels)
        d = b.copy()
        d[:, 1:] -= b[:, :-1]
        return d.tobytes()
    return np.ascontiguousarray(arr).tobytes()


def _encode_chunk(arr: np.ndarray, comp_code: int, predictor: int) -> bytes:
    """One strip/tile array -> compressed payload bytes."""
    data = _apply_predictor(arr, predictor)
    if comp_code == _COMP_DEFLATE:
        return zlib.compress(data, 6)
    if comp_code == _COMP_LZW:
        return _lzw_encode(data)
    return data


def _decode_chunk(raw: bytes, comp_code: int, predictor: int, rows: int,
                  width: int, channels: int, dtype) -> np.ndarray:
    """Compressed payload -> (rows, width, channels) array (the reader's
    and the COG stream-writer's overview-readback shared path)."""
    n_bytes = rows * width * channels * np.dtype(dtype).itemsize
    if comp_code in (8, 32946):  # DEFLATE (and the old Deflate code)
        raw = zlib.decompress(raw)
    elif comp_code == _COMP_LZW:
        raw = _lzw_decode(raw, decoded_size=n_bytes)
    elif comp_code == 32773:
        raw = _packbits_decode(raw)
    elif comp_code != 1:
        raise ValueError(f"unsupported TIFF compression {comp_code}")
    return _undo_predictor(raw, predictor, np.dtype(dtype), rows, width,
                           channels)


def coerce_sample_dtype(dtype) -> np.dtype:
    """The dtype a raster of ``dtype`` is written as: itself when TIFF can
    hold it, float32 otherwise (e.g. bfloat16/float16 model outputs)."""
    dtype = np.dtype(dtype)
    return dtype if dtype in _SAMPLE_FORMATS else np.dtype(np.float32)


def _as_hwc(image: np.ndarray) -> np.ndarray:
    image = np.asarray(image)
    if image.ndim == 2:
        image = image[..., None]
    image = image.astype(coerce_sample_dtype(image.dtype), copy=False)
    return np.ascontiguousarray(image)


def write_geotiff(
    path: str,
    image: np.ndarray,
    transform: Optional[Sequence[float]] = None,
    crs: str = "",
    nodata=None,
    compress=True,
    bigtiff: Optional[bool] = None,
    predictor: int = 1,
) -> None:
    """Write an (H, W[, C]) array as a striped GeoTIFF.

    ``transform`` is the EE/GDAL-style affine row-major 2x3:
    (xscale, xshear, xtrans, yshear, yscale, ytrans)
    (utils/prediction_tools.py:450-455). ``bigtiff`` None = auto: use
    64-bit offsets when the raster would overflow classic TIFF's 4 GiB.
    ``compress``: False/'none', True/'deflate', or 'lzw' (GDAL's COG
    default); ``predictor``: 1 none, 2 integer horizontal differencing,
    3 floating-point byte-plane differencing.
    """
    image = _as_hwc(image)
    if predictor != 1:
        _check_predictor(predictor, image.dtype)
    if bigtiff is None:
        h, w, c = image.shape
        bigtiff = _auto_bigtiff(h, w, c, image.dtype.itemsize,
                                expand=_auto_expand(_norm_compress(compress)))
    _write_pages(path, [(image, transform, crs, nodata, compress, None, None)],
                 big=bigtiff, predictor=predictor)


def _pool_2x2(level: np.ndarray) -> np.ndarray:
    """One overview step: 2x2 mean for floats, decimation for ints (the
    shared rule of write_cog and GeoTiffCogStreamWriter)."""
    h2 = level.shape[0] // 2 * 2
    w2 = level.shape[1] // 2 * 2
    p = level[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2, level.shape[2])
    if np.issubdtype(level.dtype, np.floating):
        return p.mean(axis=(1, 3)).astype(level.dtype)
    return p[:, 0, :, 0]


def _halve_transform(transform):
    """The affine of a 2x-decimated overview: overview pixel (x', y') maps
    to full-res (2x', 2y'), i.e. compose with diag(2, 2) — scale AND
    shear terms double."""
    if transform is None:
        return None
    a, b, tx, d, e, ty = transform
    return (a * 2, b * 2, tx, d * 2, e * 2, ty)


def _n_overview_levels(height, width, tile_size):
    n, m = 0, max(height, width)
    while m > tile_size:
        m //= 2
        n += 1
    return n


def write_cog(
    path: str,
    image: np.ndarray,
    transform: Optional[Sequence[float]] = None,
    crs: str = "",
    nodata=None,
    tile_size: int = 256,
    overview_levels: Optional[int] = None,
    compress=True,
    bigtiff: Optional[bool] = None,
    predictor: int = 1,
) -> None:
    """Write a Cloud-Optimized GeoTIFF: tiled base page + mean-pooled
    overview pages (the gdal.Translate COG path of
    utils/raster_tools.py:400-409). ``bigtiff`` None = auto (see
    :func:`write_geotiff`); ``compress``/``predictor`` as in
    :func:`write_geotiff` ('lzw' + predictor 2 is GDAL's common COG
    recipe)."""
    image = _as_hwc(image)
    if predictor != 1:
        _check_predictor(predictor, image.dtype)
    if bigtiff is None:
        h, w, c = image.shape
        bigtiff = _auto_bigtiff(h, w, c, image.dtype.itemsize,
                                tile_size=tile_size, overviews=True,
                                expand=_auto_expand(_norm_compress(compress)))
    pages = [(image, transform, crs, nodata, compress, tile_size, None)]
    level = image
    n_levels = overview_levels
    if n_levels is None:
        n_levels = _n_overview_levels(image.shape[0], image.shape[1],
                                      tile_size)
    scale = transform
    for _ in range(n_levels):
        level = _pool_2x2(level)
        scale = _halve_transform(scale)
        pages.append((level, scale, crs, nodata, compress, tile_size, 1))
        if min(level.shape[:2]) <= 1:
            break
    _write_pages(path, pages, big=bigtiff, predictor=predictor)


class _RowStreamBase:
    """Shared push-API plumbing for the streaming writers: validates row
    blocks, buffers until one band (``_band_rows`` rows) is full, then
    hands complete bands to the subclass's ``_flush_band``.

    ``close()`` is failure-safe: any error while flushing/finalizing
    aborts the writer (file handle closed, header still pointing at 0 —
    deliberately not a valid TIFF) and re-raises; a retried ``close()``
    is then a no-op rather than a corrupting resume."""

    def _init_stream(self, path, height, width, channels, dtype,
                     band_rows, bigtiff):
        if height <= 0 or width <= 0 or channels <= 0:
            raise ValueError("height/width/channels must be positive")
        self._big = bigtiff
        self.shape = (height, width, channels)
        self.dtype = dtype
        self._band_rows = band_rows
        self._f = open(path, "wb")
        self._f.write(_header_bytes(bigtiff, 0))  # IFD ptr patched at close
        self._pos = self._f.tell()
        self._pending: list = []  # buffered rows short of one band
        self._pending_rows = 0
        self._rows_written = 0
        self._closed = False

    def _coalesce(self) -> np.ndarray:
        return (np.concatenate(self._pending) if len(self._pending) > 1
                else self._pending[0])

    def _write_chunk(self, arr: np.ndarray, offsets: list, counts: list):
        """Compress + append one strip/tile payload, tracking offsets."""
        chunk = _encode_chunk(arr, self._comp_code, self._predictor)
        if not self._big and self._pos + len(chunk) > _CLASSIC_LIMIT:
            # raise at the first chunk that would overflow, not inside
            # close()'s struct.pack (the auto estimate is conservative, so
            # this only fires when bigtiff=False was forced)
            raise ValueError(
                "output exceeds the classic-TIFF 4 GiB offset limit; "
                "pass bigtiff=True or split the output")
        offsets.append(self._pos)
        counts.append(len(chunk))
        self._f.write(chunk)
        self._pos += len(chunk)
        if len(chunk) % 2:
            self._f.write(b"\x00")
            self._pos += 1

    def write_rows(self, rows: np.ndarray) -> None:
        """Append the next (rows, W[, C]) block; blocks must arrive in row
        order and sum to exactly ``height`` by :meth:`close`."""
        if self._closed:
            raise ValueError("writer is closed")
        rows = np.asarray(rows)
        if rows.ndim == 2:
            rows = rows[..., None]
        h, w, c = self.shape
        if rows.shape[1:] != (w, c):
            raise ValueError(f"row block shape {rows.shape} != (*, {w}, {c})")
        if rows.dtype != self.dtype:
            raise ValueError(f"row block dtype {rows.dtype} != {self.dtype}")
        if self._rows_written + rows.shape[0] > h:
            raise ValueError(
                f"rows overflow: {self._rows_written} + {rows.shape[0]} > {h}")
        self._rows_written += rows.shape[0]
        self._pending.append(rows)
        self._pending_rows += rows.shape[0]
        while self._pending_rows >= self._band_rows:
            buf = self._coalesce()
            self._flush_band(buf[: self._band_rows])
            rest = buf[self._band_rows:]
            self._pending = [rest] if rest.shape[0] else []
            self._pending_rows = rest.shape[0]

    def abort(self) -> None:
        """Close the file handle WITHOUT finalizing: no IFD is written and
        the header still points at offset 0, so the file is not a valid
        TIFF — the honest state after a failed stream."""
        if not self._closed:
            self._f.close()
            self._closed = True

    def close(self) -> None:
        """Flush the final partial band, write the IFD(s), patch the
        header. On any failure the writer aborts and re-raises."""
        if self._closed:
            return
        if self._rows_written != self.shape[0]:
            self.abort()
            raise ValueError(
                f"wrote {self._rows_written} rows, expected {self.shape[0]}")
        try:
            if self._pending_rows:
                self._flush_band(self._coalesce())
                self._pending, self._pending_rows = [], 0
            self._finalize()
        except BaseException:
            self.abort()
            raise
        self._f.close()
        self._closed = True

    def _flush_band(self, band: np.ndarray) -> None:
        raise NotImplementedError

    def _finalize(self) -> None:
        """Write the IFD chain and patch the header pointer."""
        raise NotImplementedError

    def _patch_header(self, first_ifd: int) -> None:
        seek, fmt = _ptr_patch(self._big)
        self._f.seek(seek)
        self._f.write(struct.pack(fmt, first_ifd))

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            self.abort()
        return False


class GeoTiffStreamWriter(_RowStreamBase):
    """Incremental striped-GeoTIFF writer: rows stream to disk as they are
    produced, so host memory stays O(strip) no matter how tall the scene.

    The write-side twin of :class:`GeoTiffScene` — together they close the
    swath-scale serving loop (GeoTIFF in → banded inference → GeoTIFF out)
    at O(band) host memory. The reference materializes the whole output
    array before its rasterio write (utils/prediction_tools.py:447-536).

    Layout: header (IFD pointer patched on close) → pixel strips in row
    order → IFD at end of file. Readers follow the header pointer, so the
    trailing IFD is ordinary TIFF; files are bit-readable by
    :class:`GeoTiffScene` / ``read_geotiff``.

    Usage::

        with GeoTiffStreamWriter(path, h, w, c, np.uint8, crs=...) as wr:
            for block in row_blocks:      # (rows, w, c), top to bottom
                wr.write_rows(block)
    """

    def __init__(
        self,
        path: str,
        height: int,
        width: int,
        channels: int,
        dtype,
        transform: Optional[Sequence[float]] = None,
        crs: str = "",
        nodata=None,
        compress=True,
        rows_per_strip: Optional[int] = None,
        bigtiff: Optional[bool] = None,
        predictor: int = 1,
    ):
        dtype = np.dtype(dtype)
        if dtype not in _SAMPLE_FORMATS:
            raise ValueError(f"unsupported sample dtype {dtype}")
        comp_code = _norm_compress(compress)
        if predictor != 1:
            _check_predictor(predictor, dtype)
        if bigtiff is None:
            # auto: 64-bit offsets when the raster would overflow classic
            # TIFF's 4 GiB — decided up front (strips stream; no second pass)
            bigtiff = _auto_bigtiff(height, width, channels, dtype.itemsize,
                                    expand=_auto_expand(comp_code))
        elif not bigtiff and comp_code == _COMP_NONE and _auto_bigtiff(
                height, width, channels, dtype.itemsize):
            # forced classic + uncompressed: the overflow is knowable now —
            # fail at construction, not after hours of streaming
            raise ValueError(
                "uncompressed raster exceeds the classic-TIFF 4 GiB offset "
                "limit; pass bigtiff=True or split the output")
        self._geo = (transform, crs, nodata)
        self._comp_code = comp_code
        self._predictor = predictor
        self._rps = rows_per_strip or _default_rows_per_strip(
            width, channels, dtype.itemsize)
        self._init_stream(path, height, width, channels, dtype,
                          self._rps, bigtiff)
        self._offsets: list = []
        self._counts: list = []

    def _flush_band(self, band: np.ndarray) -> None:
        self._write_chunk(band, self._offsets, self._counts)

    def _finalize(self) -> None:
        h, w, c = self.shape
        transform, crs, nodata = self._geo
        b = _IFDBuilder(self._big)
        _base_tags(b, h, w, c, self.dtype, self._comp_code, transform, crs,
                   nodata, predictor=self._predictor)
        off_t = _off_type(self._big)
        b.add(_ROWS_PER_STRIP, _TYPE_LONG, self._rps)
        b.add(_STRIP_OFFSETS, off_t, self._offsets)
        b.add(_STRIP_BYTE_COUNTS, off_t, self._counts)
        ifd_bytes, outline = b.serialize(self._pos)
        first_ifd = self._pos
        self._f.write(ifd_bytes)
        self._f.write(outline)
        self._patch_header(first_ifd)


class GeoTiffCogStreamWriter(_RowStreamBase):
    """Incremental tiled-GeoTIFF writer WITH mean-pooled overview pyramids
    — COG-style output for rasters larger than host RAM.

    Same push API as :class:`GeoTiffStreamWriter` (``write_rows`` in row
    order, then ``close``), but the base page is tiled and ``close()``
    builds the overview levels by reading the just-written tiles back
    from disk band-by-band and 2x2-pooling them level by level (floats:
    mean; ints: decimation — matching :func:`write_cog`). Peak host
    memory is O(tile_size × W × C) regardless of scene height.

    Layout: header → base tiles (streamed) → level-1 tiles → … → all
    IFDs (chained) at the end of file, header patched to the first. The
    IFD-last layout trades the COG spec's header-first read optimization
    for single-pass writability; readers that follow the header pointer
    (GDAL, :class:`GeoTiffScene`) read it as an ordinary tiled GeoTIFF
    with overviews. Reference: utils/raster_tools.py:411-461 materializes
    the full raster before gdal.Translate."""

    def __init__(
        self,
        path: str,
        height: int,
        width: int,
        channels: int,
        dtype,
        transform: Optional[Sequence[float]] = None,
        crs: str = "",
        nodata=None,
        compress=True,
        tile_size: int = 256,
        overview_levels: Optional[int] = None,
        bigtiff: Optional[bool] = None,
        predictor: int = 1,
    ):
        dtype = np.dtype(dtype)
        if dtype not in _SAMPLE_FORMATS:
            raise ValueError(f"unsupported sample dtype {dtype}")
        if tile_size % 16:
            raise ValueError("TIFF tile dimensions must be multiples of 16")
        comp_code = _norm_compress(compress)
        if bigtiff is None:
            bigtiff = _auto_bigtiff(height, width, channels, dtype.itemsize,
                                    tile_size=tile_size, overviews=True,
                                    expand=_auto_expand(comp_code))
        self._geo = (transform, crs, nodata)
        self._comp_code = comp_code
        self._predictor = (_check_predictor(predictor, dtype)
                           if predictor != 1 else 1)
        self._ts = tile_size
        if overview_levels is None:
            overview_levels = _n_overview_levels(height, width, tile_size)
        self._n_levels = overview_levels
        self._init_stream(path, height, width, channels, dtype,
                          tile_size, bigtiff)
        # per-page: dict(h, w, offsets, counts) — filled as pages stream
        self._pages: list = [
            {"h": height, "w": width, "offsets": [], "counts": []}]

    # -- tile-band plumbing ---------------------------------------------
    def _flush_tile_band(self, page, band: np.ndarray) -> None:
        """Write one horizontal band (≤ tile_size rows, full width) of a
        page as zero-padded tiles (the same padding _page_ifd applies)."""
        ts = self._ts
        n, w = band.shape[0], page["w"]
        c = self.shape[2]
        for tx in range(0, w, ts):
            tile = np.zeros((ts, ts, c), self.dtype)
            sub = band[:, tx : tx + ts]
            tile[:n, : sub.shape[1]] = sub
            self._write_chunk(tile, page["offsets"], page["counts"])

    def _flush_band(self, band: np.ndarray) -> None:
        self._flush_tile_band(self._pages[0], band)

    def _read_band(self, page, y0: int, n: int) -> np.ndarray:
        """Read rows [y0, y0+n) of an already-written page from disk."""
        ts = self._ts
        w, c = page["w"], self.shape[2]
        out = np.zeros((n, w, c), self.dtype)
        tiles_across = -(-w // ts)
        self._f.flush()
        with open(self._f.name, "rb") as rf:
            for ty in range(y0 // ts * ts, min(y0 + n, page["h"]), ts):
                trow = ty // ts
                for ix in range(tiles_across):
                    i = trow * tiles_across + ix
                    rf.seek(page["offsets"][i])
                    raw = rf.read(page["counts"][i])
                    tile = _decode_chunk(raw, self._comp_code,
                                         self._predictor, ts, ts, c,
                                         self.dtype)
                    ylo, yhi = max(ty, y0), min(ty + ts, y0 + n, page["h"])
                    xlo, xhi = ix * ts, min(ix * ts + ts, w)
                    out[ylo - y0 : yhi - y0, xlo:xhi] = tile[
                        ylo - ty : yhi - ty, : xhi - xlo]
        return out

    def _finalize(self) -> None:
        h, w, c = self.shape
        # overview cascade: each level streams off the previous one's
        # tiles in 2·tile_size-row source bands → one ≤tile_size-row band
        # per iteration (2·ts source rows pool to exactly ts rows, the
        # last band to whatever remains)
        for _ in range(self._n_levels):
            src = self._pages[-1]
            lh, lw = src["h"] // 2, src["w"] // 2
            if lh < 1 or lw < 1:
                break
            page = {"h": lh, "w": lw, "offsets": [], "counts": []}
            self._pages.append(page)
            for y0 in range(0, src["h"] // 2 * 2, 2 * self._ts):
                n = min(2 * self._ts, src["h"] // 2 * 2 - y0)
                self._flush_tile_band(
                    page, _pool_2x2(self._read_band(src, y0, n)))
            if min(lh, lw) <= 1:
                break

        # IFD chain at end of file; header patched to the first
        transform, crs, nodata = self._geo
        builders = []
        tf_level = transform
        off_t = _off_type(self._big)
        for i, page in enumerate(self._pages):
            b = _IFDBuilder(self._big)
            _base_tags(b, page["h"], page["w"], c, self.dtype,
                       self._comp_code, tf_level, crs, nodata,
                       subfile_type=1 if i else None,
                       predictor=self._predictor)
            b.add(_TILE_WIDTH, _TYPE_LONG, self._ts)
            b.add(_TILE_LENGTH, _TYPE_LONG, self._ts)
            b.add(_TILE_OFFSETS, off_t, page["offsets"])
            b.add(_TILE_BYTE_COUNTS, off_t, page["counts"])
            builders.append(b)
            tf_level = _halve_transform(tf_level)
        sizes = []
        for b in builders:
            ifd, outline = b.serialize(self._pos)  # measure
            sizes.append(len(ifd) + len(outline))
        first_ifd = self._pos
        pos = first_ifd
        for i, (b, size) in enumerate(zip(builders, sizes)):
            nxt = pos + size if i + 1 < len(builders) else 0
            ifd, outline = b.serialize(pos, nxt)
            self._f.write(ifd)
            self._f.write(outline)
            pos += size
        self._patch_header(first_ifd)


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


def _lzw_encode(data: bytes) -> bytes:
    """TIFF-flavor LZW encode (compression 5, early-change width
    schedule): the write-side twin of :func:`_lzw_decode`, so this codec
    emits the compression GDAL defaults to for COG assets. Routes through
    the native module (native/fastrecord.cc scv_lzw_encode, ~130 MB/s on an idle host)
    when available; the pure-Python fallback is identical bit-for-bit.
    The early-change bump is pinned empirically against the decoder: the
    decoder's table lags the encoder's by one entry and bumps at
    ``len(table) == 2**nbits - 1``, so the encoder bumps at
    ``next_code == 2**nbits``."""
    from satellite_computervision_tpu_torch import native

    enc = native.lzw_encode(data)
    if enc is not None:
        return enc
    CLEAR, EOI, FIRST, MAXC = 256, 257, 258, 4096
    out = bytearray()
    acc = 0
    nacc = 0

    def put(code, nbits):
        nonlocal acc, nacc
        acc = (acc << nbits) | code
        nacc += nbits
        while nacc >= 8:
            out.append((acc >> (nacc - 8)) & 0xFF)
            nacc -= 8

    nbits, next_code, table = 9, FIRST, {}
    put(CLEAR, nbits)
    if data:
        prev = data[0]
        for c in data[1:]:
            key = (prev << 8) | c
            if key in table:
                prev = table[key]
                continue
            put(prev, nbits)
            table[key] = next_code
            next_code += 1
            if next_code == (1 << nbits) and nbits < 12:
                nbits += 1
            if next_code >= MAXC - 1:
                put(CLEAR, nbits)
                nbits, next_code, table = 9, FIRST, {}
            prev = c
        put(prev, nbits)
        # the final data code adds no encoder entry, but the decoder
        # appends one for it and may widen before its next read — EOI
        # must land at the decoder's width (decoder table len ==
        # next_code after the final emit)
        if next_code == (1 << nbits) - 1 and nbits < 12:
            nbits += 1
    put(EOI, nbits)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def _lzw_decode(data: bytes, decoded_size: Optional[int] = None) -> bytes:
    """TIFF-flavor LZW (MSB-first bit packing, 9→12-bit codes with the
    libtiff "early change" — code width bumps one entry early). This is
    the compression GDAL/rasterio commonly emit for COG assets
    (reference reads them via rasterio: utils/raster_tools.py:367-461),
    so the self-contained reader must decode it. With ``decoded_size``
    (known from the TIFF chunk geometry) the native decoder
    (scv_lzw_decode, ~150 MB/s idle — ~100x this loop) handles it."""
    if decoded_size is not None:
        from satellite_computervision_tpu_torch import native

        dec = native.lzw_decode(data, decoded_size)
        if dec is not None:
            return dec
    CLEAR, EOI = 256, 257
    out = bytearray()
    table: list = []
    nbits = 9
    bitpos = 0
    total = len(data) * 8
    prev = b""
    while bitpos + nbits <= total:
        byte0 = bitpos >> 3
        window = int.from_bytes(data[byte0 : byte0 + 4].ljust(4, b"\x00"),
                                "big")
        code = (window >> (32 - nbits - (bitpos & 7))) & ((1 << nbits) - 1)
        bitpos += nbits
        if code == CLEAR:
            table = [bytes([i]) for i in range(256)] + [b"", b""]
            nbits = 9
            prev = b""
            continue
        if code == EOI:
            break
        if not table:
            raise ValueError("LZW stream does not start with a clear code")
        if not prev:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError("corrupt LZW stream: code beyond table")
        out += entry
        prev = entry
        # early change: the ENCODER widens when the next emitted code's
        # table index reaches 2^nbits - 1, so mirror that here
        if len(table) == (1 << nbits) - 1 and nbits < 12:
            nbits += 1
    return bytes(out)


def _packbits_decode(data: bytes) -> bytes:
    """PackBits run-length decoding (TIFF compression 32773)."""
    out = bytearray()
    i = 0
    n_in = len(data)
    while i < n_in:
        n = data[i]
        i += 1
        if n < 128:
            out += data[i : i + n + 1]
            i += n + 1
        elif n > 128:
            out += data[i : i + 1] * (257 - n)
            i += 1
        # n == 128: no-op per spec
    return bytes(out)


def _undo_predictor(raw: bytes, predictor: int, dtype, rows: int,
                    width: int, channels: int) -> np.ndarray:
    """Reverse the TIFF predictor (tag 317) over one decompressed chunk
    and return the (rows, width, channels) array. Predictor 2 is
    per-sample horizontal differencing (integer, modulo wraparound);
    predictor 3 is the floating-point flavor: rows are stored as
    byte-planes (MSB plane first) with byte-wise differencing at stride
    = samples-per-pixel over the flat planar buffer (libtiff
    tif_predict.c fpAcc — stride is the channel count, so multiband
    files difference each channel's byte lane independently)."""
    if predictor == 3:
        if dtype.kind != "f":
            raise ValueError("predictor 3 requires floating-point samples")
        it = dtype.itemsize
        b = np.frombuffer(raw, np.uint8).reshape(rows, it * width, channels)
        b = np.cumsum(b, axis=1, dtype=np.uint8)
        planes = b.reshape(rows, it, width * channels)
        # plane 0 holds each value's most-significant byte → big-endian
        be = np.ascontiguousarray(planes.transpose(0, 2, 1))
        arr = be.view(np.dtype(dtype.str.replace("<", ">")))
        return arr.reshape(rows, width, channels).astype(dtype)
    arr = np.frombuffer(raw, dtype).reshape(rows, width, channels)
    if predictor == 2:
        if dtype.kind not in "ui":
            raise ValueError("predictor 2 requires integer samples")
        u = arr.view(np.dtype(f"u{dtype.itemsize}"))
        return np.cumsum(u, axis=1, dtype=u.dtype).view(dtype)
    if predictor != 1:
        raise ValueError(f"unsupported TIFF predictor {predictor}")
    return arr


def _parse_page_tags(f, page: int = 0):
    """Parse one IFD's tags from an open file (classic or BigTIFF).
    Seek-based: only the directory (and out-of-line tag payloads) are
    read, never the raster data — the basis of the windowed reader
    below."""
    f.seek(0)
    header = f.read(16)
    if header[:4] == b"II*\x00":
        big = False
        (ifd_offset,) = struct.unpack_from("<I", header, 4)
    elif header[:4] == b"II+\x00":
        offsize, pad = struct.unpack_from("<HH", header, 4)
        if offsize != 8 or pad != 0:
            raise ValueError(f"unsupported BigTIFF offset size {offsize}")
        big = True
        (ifd_offset,) = struct.unpack_from("<Q", header, 8)
    else:
        raise ValueError("not a little-endian TIFF")
    cnt_fmt, cnt_sz = ("<Q", 8) if big else ("<H", 2)
    off_fmt, off_sz = ("<Q", 8) if big else ("<I", 4)
    entry_sz, inline = (20, 8) if big else (12, 4)
    for _ in range(page):
        f.seek(ifd_offset)
        (count,) = struct.unpack(cnt_fmt, f.read(cnt_sz))
        f.seek(ifd_offset + cnt_sz + count * entry_sz)
        (ifd_offset,) = struct.unpack(off_fmt, f.read(off_sz))
        if ifd_offset == 0:
            raise IndexError("page out of range")
    f.seek(ifd_offset)
    (count,) = struct.unpack(cnt_fmt, f.read(cnt_sz))
    entries = f.read(count * entry_sz)
    tags = {}
    value_fmts = {3: "<H", 4: "<I", 12: "<d", 11: "<f", 1: "<B",
                  6: "<b", 8: "<h", 9: "<i", 16: "<Q", 17: "<q"}
    for i in range(count):
        tag, type_ = struct.unpack_from("<HH", entries, i * entry_sz)
        (n,) = struct.unpack_from(off_fmt, entries, i * entry_sz + 4)
        if type_ not in _TYPE_SIZES:
            continue  # unknown tag type — skip, per TIFF 6.0 readers' rule
        size = _TYPE_SIZES[type_] * n
        value_at = i * entry_sz + 4 + off_sz
        if size > inline:
            (data_off,) = struct.unpack_from(off_fmt, entries, value_at)
            f.seek(data_off)
            payload = f.read(size)
        else:
            payload = entries[value_at : value_at + size]
        if type_ == _TYPE_ASCII:
            tags[tag] = payload.rstrip(b"\x00").decode("ascii", "replace")
        elif type_ in (5, 10):  # (S)RATIONAL: numerator/denominator pairs
            sub = "<II" if type_ == 5 else "<ii"
            tags[tag] = [
                (lambda num, den: num / den if den else 0.0)(
                    *struct.unpack_from(sub, payload, j * 8))
                for j in range(n)
            ]
        elif type_ in value_fmts:
            fmt = value_fmts[type_]
            step = _TYPE_SIZES[type_]
            tags[tag] = [
                struct.unpack_from(fmt, payload, j * step)[0] for j in range(n)
            ]
        # types we can size but not interpret (7 UNDEFINED, 18 IFD8...):
        # sized correctly above, value skipped
    return tags


def _tags_to_meta(tags) -> dict:
    meta = {}
    if _MODEL_PIXEL_SCALE in tags and _MODEL_TIEPOINT in tags:
        sx, sy, _ = tags[_MODEL_PIXEL_SCALE]
        tp = tags[_MODEL_TIEPOINT]
        meta["transform"] = (sx, 0.0, tp[3], 0.0, -sy, tp[4])
    elif _MODEL_TRANSFORMATION in tags:
        m = tags[_MODEL_TRANSFORMATION]
        meta["transform"] = (m[0], m[1], m[3], m[4], m[5], m[7])
    if _GEO_ASCII_PARAMS in tags:
        meta["crs"] = tags[_GEO_ASCII_PARAMS].rstrip("|")
    elif _GEO_KEY_DIRECTORY in tags:
        d = tags[_GEO_KEY_DIRECTORY]
        for j in range(4, len(d), 4):  # scan keys for an EPSG code
            if d[j] in (2048, 3072):
                meta["crs"] = f"EPSG:{d[j + 3]}"
    if _GDAL_NODATA in tags:
        meta["nodata"] = float(tags[_GDAL_NODATA])
    return meta


class GeoTiffScene:
    """Lazy windowed GeoTIFF reader: parses the IFD once, then reads ONLY
    the strips/tiles a requested window touches (one short-lived file
    handle per read — safe from the banded pipeline's staging thread).

    Drop-in scene for ``TiledInferenceEngine`` banded streaming
    (``max_rows``): host memory stays O(band), so scenes larger than RAM
    serve straight from disk. The reference materializes whole scenes
    through xarray before chipping (utils/pc_tools.py:620-668,
    utils/prediction_tools.py:731-779).

    Indexing: ``scene[r0:r1]``, ``scene[r0:r1, c0:c1]`` (unit step)
    returns an (rows, cols, C) NumPy array; ``np.asarray(scene)`` reads
    everything.
    """

    lazy = True  # TiledInferenceEngine checks this to avoid materializing

    def __init__(self, path: str, page: int = 0):
        self.path = path
        with open(path, "rb") as f:
            tags = self._tags = _parse_page_tags(f, page)
        w = tags[_IMAGE_WIDTH][0]
        h = tags[_IMAGE_LENGTH][0]
        c = tags.get(_SAMPLES_PER_PIXEL, [1])[0]
        bits = tags[_BITS_PER_SAMPLE][0]
        sample_format = tags.get(_SAMPLE_FORMAT, [1])[0]
        self._compression = tags.get(_COMPRESSION, [1])[0]
        self._predictor = tags.get(_PREDICTOR, [1])[0]
        self.dtype = np.dtype(
            {
                (1, 8): np.uint8,
                (1, 16): np.uint16,
                (1, 32): np.uint32,
                (2, 16): np.int16,
                (2, 32): np.int32,
                (3, 32): np.float32,
                (3, 64): np.float64,
            }[(sample_format, bits)]
        )
        self.shape = (h, w, c)
        self.meta = _tags_to_meta(tags)
        self.nodata = self.meta.get("nodata")

    @property
    def ndim(self) -> int:
        return 3

    def _decode(self, f, off, n_bytes, rows, width):
        """Read + decompress one strip/tile and undo the predictor,
        returning a (rows, width, C) array (LZW chunks route through the
        native decoder — the chunk geometry fixes the decoded size)."""
        f.seek(off)
        raw = f.read(n_bytes)
        return _decode_chunk(raw, self._compression, self._predictor,
                             rows, width, self.shape[2], self.dtype)

    @staticmethod
    def _axis_range(key, size):
        if isinstance(key, slice):
            lo, hi, step = key.indices(size)
            if step != 1:
                raise IndexError("GeoTiffScene supports unit-step slices only")
            return lo, max(lo, hi)
        raise IndexError("GeoTiffScene supports slice indexing only")

    def __getitem__(self, key) -> np.ndarray:
        h, w, c = self.shape
        if not isinstance(key, tuple):
            key = (key,)
        if len(key) > 3:
            raise IndexError("too many indices")
        key = key + (slice(None),) * (3 - len(key))
        r0, r1 = self._axis_range(key[0], h)
        c0, c1 = self._axis_range(key[1], w)
        b0, b1 = self._axis_range(key[2], c)
        out = np.zeros((r1 - r0, c1 - c0, c), self.dtype)
        tags = self._tags
        with open(self.path, "rb") as f:
            if _TILE_OFFSETS in tags:
                ts = tags[_TILE_WIDTH][0]
                tl = tags.get(_TILE_LENGTH, [ts])[0]
                tiles_across = -(-w // ts)
                offsets, counts = tags[_TILE_OFFSETS], tags[_TILE_BYTE_COUNTS]
                for ty in range(r0 // tl * tl, r1, tl):
                    for tx in range(c0 // ts * ts, c1, ts):
                        i = (ty // tl) * tiles_across + tx // ts
                        tile = self._decode(f, offsets[i], counts[i], tl, ts)
                        ylo, yhi = max(ty, r0), min(ty + tl, r1, h)
                        xlo, xhi = max(tx, c0), min(tx + ts, c1, w)
                        out[ylo - r0 : yhi - r0, xlo - c0 : xhi - c0] = tile[
                            ylo - ty : yhi - ty, xlo - tx : xhi - tx
                        ]
            else:
                rps = tags.get(_ROWS_PER_STRIP, [h])[0]
                offsets, counts = tags[_STRIP_OFFSETS], tags[_STRIP_BYTE_COUNTS]
                for si in range(r0 // rps, -(-r1 // rps)):
                    if si >= len(offsets):
                        break
                    sy = si * rps
                    rows = min(rps, h - sy)
                    strip = self._decode(f, offsets[si], counts[si], rows, w)
                    ylo, yhi = max(sy, r0), min(sy + rows, r1)
                    out[ylo - r0 : yhi - r0] = strip[ylo - sy : yhi - sy, c0:c1]
        return out[..., b0:b1]

    def __array__(self, dtype=None, copy=None):
        arr = self[:, :]
        return arr.astype(dtype) if dtype is not None else arr


def read_geotiff(path: str, page: int = 0):
    """Read an (H, W, C) array + metadata dict from a GeoTIFF written by
    this module (and simple single-plane TIFFs generally)."""
    scene = GeoTiffScene(path, page)
    return scene[:, :], scene.meta

"""Affine geo<->pixel transforms and training-window sampling.

The port's own numpy copy of ``satellite_computervision_tpu/geo/
transforms.py`` (reference: utils/raster_tools.py:70-331, shapely/
affine-based). Here geometries are plain NumPy (N, 2) coordinate arrays
and affines are a small named tuple, so no GIS stack is required.

Affine convention matches GDAL/EE row-major 2x3:
``(a, b, c, d, e, f)`` with ``x_geo = a*col + b*row + c`` and
``y_geo = d*col + e*row + f``.
"""

from __future__ import annotations

import random
from typing import NamedTuple, Sequence, Tuple

import numpy as np


class Affine(NamedTuple):
    a: float
    b: float
    c: float
    d: float
    e: float
    f: float

    def __call__(self, col, row):
        return (
            self.a * col + self.b * row + self.c,
            self.d * col + self.e * row + self.f,
        )

    def inverse(self) -> "Affine":
        det = self.a * self.e - self.b * self.d
        if det == 0:
            raise ValueError("singular affine")
        ia, ib = self.e / det, -self.b / det
        id_, ie = -self.d / det, self.a / det
        ic = -(ia * self.c + ib * self.f)
        if_ = -(id_ * self.c + ie * self.f)
        return Affine(ia, ib, ic, id_, ie, if_)


def geo_transform_from_mixer(mixer_affine: Sequence[float]) -> Affine:
    """EE mixer doubleMatrix -> Affine (utils/raster_tools.py:120-142)."""
    return Affine(*mixer_affine[:6])


def pixel_to_geo(transform: Affine, cols, rows):
    """(col, row) pixel coords -> geo coords."""
    t = Affine(*transform)
    return t(np.asarray(cols, float), np.asarray(rows, float))


def geo_to_pixel(transform: Affine, xs, ys):
    """geo coords -> fractional (col, row) pixel coords."""
    inv = Affine(*transform).inverse()
    return inv(np.asarray(xs, float), np.asarray(ys, float))


def convert_poly_coords(coords, transform: Affine, inverse: bool = False):
    """Transform an (N, 2) coordinate array pixel->geo (or geo->pixel with
    ``inverse=True``) — utils/raster_tools.py:144-214 without shapely."""
    coords = np.asarray(coords, float)
    t = Affine(*transform)
    if inverse:
        t = t.inverse()
    x, y = t(coords[..., 0], coords[..., 1])
    return np.stack([x, y], axis=-1)


def convert_pt(pt: Tuple[float, float], transform: Affine, inverse: bool = False):
    """Single-point variant (utils/raster_tools.py:216-233)."""
    return tuple(convert_poly_coords(np.asarray([pt]), transform, inverse)[0])


def convert_yolo_bbox(box, img_size) -> Tuple[float, float, float, float]:
    """Pixel box (xmin, xmax, ymin, ymax) -> normalized YOLO (x, y, w, h)
    (utils/raster_tools.py:70-96)."""
    dw = 1.0 / img_size[0]
    dh = 1.0 / img_size[1]
    x = (box[0] + box[1]) / 2.0
    y = (box[2] + box[3]) / 2.0
    w = box[1] - box[0]
    h = box[3] - box[2]
    return (x * dw, y * dh, w * dw, h * dh)


def array_bounds(height: int, width: int, transform: Affine):
    """(left, bottom, right, top) geo bounds of an (H, W) raster
    (the rasterio.transform.array_bounds used at
    utils/prediction_tools.py:560-600)."""
    t = Affine(*transform)
    corners = [t(0, 0), t(width, 0), t(0, height), t(width, height)]
    xs = [p[0] for p in corners]
    ys = [p[1] for p in corners]
    return (min(xs), min(ys), max(xs), max(ys))


def make_window(cx: float, cy: float, size: int) -> Tuple[int, int, int, int]:
    """Square pixel window (col_off, row_off, w, h) centered on a point
    (utils/raster_tools.py:98-118)."""
    half = size // 2
    return (int(cx - half), int(cy - half), size, size)


def win_jitter(window_size: int, jitter_frac: float = 0.1, rng=random) -> Tuple[int, int]:
    """Random (dx, dy) jitter up to ``jitter_frac`` of the window
    (utils/raster_tools.py:235-249)."""
    max_j = int(window_size * jitter_frac)
    return rng.randint(-max_j, max_j), rng.randint(-max_j, max_j)


def polygon_centroid(coords) -> Tuple[float, float]:
    """Area-weighted centroid of a simple polygon ring
    (utils/raster_tools.py:251-285's shapely centroid)."""
    coords = np.asarray(coords, float)
    x, y = coords[:, 0], coords[:, 1]
    x1, y1 = np.roll(x, -1), np.roll(y, -1)
    cross = x * y1 - x1 * y
    area = cross.sum() / 2.0
    if abs(area) < 1e-12:
        return float(x.mean()), float(y.mean())
    cx = ((x + x1) * cross).sum() / (6.0 * area)
    cy = ((y + y1) * cross).sum() / (6.0 * area)
    return float(cx), float(cy)


def make_jittered_window(
    poly_coords,
    transform: Affine,
    window_size: int = 512,
    jitter_frac: float = 0.1,
    rng=random,
) -> Tuple[int, int, int, int]:
    """Training-chip window around a (jittered) polygon centroid in pixel
    space (utils/raster_tools.py:287-331)."""
    cx_geo, cy_geo = polygon_centroid(poly_coords)
    col, row = geo_to_pixel(transform, cx_geo, cy_geo)
    dx, dy = win_jitter(window_size, jitter_frac, rng)
    return make_window(float(col) + dx, float(row) + dy, window_size)

"""Self-contained coordinate reference system transforms.

The port's own numpy copy of ``satellite_computervision_tpu/geo/crs.py``.
The reference transforms prediction bounds into a target CRS for folium
display via rasterio's CRS machinery (utils/prediction_tools.py:584-597).
Without pyproj/GDAL, the transforms used by the domain are
implemented directly on the WGS84 ellipsoid:

- EPSG:4326 (lon/lat),
- EPSG:326xx / 327xx (UTM north/south, zones 1-60) via the Krueger series
  for the transverse Mercator projection (4th order — sub-millimeter
  within a zone, far below the 10 m pixels this framework maps),
- EPSG:3857 (spherical web mercator).

All functions take/return NumPy arrays (host-side geo metadata, not device
compute).
"""

from __future__ import annotations

import math
import re
from typing import Tuple

import numpy as np

# WGS84
_A = 6378137.0
_F = 1.0 / 298.257223563
_K0 = 0.9996  # UTM scale factor
_E2 = _F * (2 - _F)

# third flattening and Krueger series coefficients (4th order)
_N = _F / (2 - _F)
_N2, _N3, _N4 = _N**2, _N**3, _N**4
# rectifying radius
_A_CAP = _A / (1 + _N) * (1 + _N2 / 4 + _N4 / 64)
_ALPHA = (
    _N / 2 - 2 * _N2 / 3 + 5 * _N3 / 16 + 41 * _N4 / 180,
    13 * _N2 / 48 - 3 * _N3 / 5 + 557 * _N4 / 1440,
    61 * _N3 / 240 - 103 * _N4 / 140,
    49561 * _N4 / 161280,
)
_BETA = (
    _N / 2 - 2 * _N2 / 3 + 37 * _N3 / 96 - 1 * _N4 / 360,
    _N2 / 48 + _N3 / 15 - 437 * _N4 / 1440,
    17 * _N3 / 480 - 37 * _N4 / 840,
    4397 * _N4 / 161280,
)
_DELTA = (
    2 * _N - 2 * _N2 / 3 - 2 * _N3 + 116 * _N4 / 45,
    7 * _N2 / 3 - 8 * _N3 / 5 - 227 * _N4 / 45,
    56 * _N3 / 15 - 136 * _N4 / 35,
    4279 * _N4 / 630,
)


def parse_epsg(crs) -> int:
    """'EPSG:32617', 'epsg:4326', or a bare int -> 32617/4326."""
    if isinstance(crs, int):
        return crs
    m = re.match(r"(?i)epsg:\s*(\d+)$", str(crs).strip())
    if not m:
        raise ValueError(f"unsupported CRS spec {crs!r} (want 'EPSG:<code>')")
    return int(m.group(1))


def _utm_zone(epsg: int) -> Tuple[int, bool]:
    """EPSG UTM code -> (zone, is_north)."""
    if 32601 <= epsg <= 32660:
        return epsg - 32600, True
    if 32701 <= epsg <= 32760:
        return epsg - 32700, False
    raise ValueError(f"EPSG:{epsg} is not a WGS84 UTM zone")


def _tm_forward(lon_rad, lat_rad, lon0_rad):
    """Transverse Mercator (Krueger series): radians -> unscaled (x, y)."""
    t = np.sinh(
        np.arctanh(np.sin(lat_rad))
        - (2 * math.sqrt(_N) / (1 + _N)) * np.arctanh(
            (2 * math.sqrt(_N) / (1 + _N)) * np.sin(lat_rad)
        )
    )
    xi = np.arctan2(t, np.cos(lon_rad - lon0_rad))
    eta = np.arctanh(np.sin(lon_rad - lon0_rad) / np.sqrt(1 + t * t))
    xi_s, eta_s = xi, eta
    for j, a in enumerate(_ALPHA, start=1):
        xi_s = xi_s + a * np.sin(2 * j * xi) * np.cosh(2 * j * eta)
        eta_s = eta_s + a * np.cos(2 * j * xi) * np.sinh(2 * j * eta)
    return _A_CAP * eta_s, _A_CAP * xi_s


def _tm_inverse(x, y, lon0_rad):
    """Inverse transverse Mercator: unscaled (x, y) -> (lon, lat) radians."""
    xi = y / _A_CAP
    eta = x / _A_CAP
    xi_p, eta_p = xi, eta
    for j, b in enumerate(_BETA, start=1):
        xi_p = xi_p - b * np.sin(2 * j * xi) * np.cosh(2 * j * eta)
        eta_p = eta_p - b * np.cos(2 * j * xi) * np.sinh(2 * j * eta)
    chi = np.arcsin(np.sin(xi_p) / np.cosh(eta_p))
    lat = chi
    for j, d in enumerate(_DELTA, start=1):
        lat = lat + d * np.sin(2 * j * chi)
    lon = lon0_rad + np.arctan2(np.sinh(eta_p), np.cos(xi_p))
    return lon, lat


def utm_to_lonlat(x, y, epsg: int):
    """UTM easting/northing (meters) -> (lon, lat) degrees."""
    zone, north = _utm_zone(epsg)
    lon0 = math.radians(zone * 6 - 183)
    x = (np.asarray(x, np.float64) - 500000.0) / _K0
    y = np.asarray(y, np.float64)
    if not north:
        y = y - 10000000.0
    y = y / _K0
    lon, lat = _tm_inverse(x, y, lon0)
    return np.degrees(lon), np.degrees(lat)


def lonlat_to_utm(lon, lat, epsg: int):
    """(lon, lat) degrees -> UTM easting/northing (meters) in the zone
    named by ``epsg`` (no zone auto-selection; reprojection parity)."""
    zone, north = _utm_zone(epsg)
    lon0 = math.radians(zone * 6 - 183)
    x, y = _tm_forward(np.radians(np.asarray(lon, np.float64)),
                       np.radians(np.asarray(lat, np.float64)), lon0)
    x = _K0 * x + 500000.0
    y = _K0 * y
    if not north:
        y = y + 10000000.0
    return x, y


def webmercator_to_lonlat(x, y):
    lon = np.degrees(np.asarray(x, np.float64) / _A)
    lat = np.degrees(2 * np.arctan(np.exp(np.asarray(y, np.float64) / _A)) - np.pi / 2)
    return lon, lat


def lonlat_to_webmercator(lon, lat):
    x = _A * np.radians(np.asarray(lon, np.float64))
    y = _A * np.arctanh(np.sin(np.radians(np.asarray(lat, np.float64))))
    return x, y


def transform_points(xs, ys, src_crs, dst_crs):
    """Transform point arrays between supported CRSs (via lon/lat)."""
    src, dst = parse_epsg(src_crs), parse_epsg(dst_crs)
    if src == dst:
        return np.asarray(xs, np.float64), np.asarray(ys, np.float64)
    if src == 4326:
        lon, lat = np.asarray(xs, np.float64), np.asarray(ys, np.float64)
    elif src == 3857:
        lon, lat = webmercator_to_lonlat(xs, ys)
    else:
        lon, lat = utm_to_lonlat(xs, ys, src)
    if dst == 4326:
        return lon, lat
    if dst == 3857:
        return lonlat_to_webmercator(lon, lat)
    return lonlat_to_utm(lon, lat, dst)


def transform_bounds(left, bottom, right, top, src_crs, dst_crs, densify: int = 21):
    """Reproject a bounding box by densifying its edges (the curvature-safe
    equivalent of rasterio.warp.transform_bounds, which the reference's
    get_img_bounds relies on for folium display,
    utils/prediction_tools.py:584-597)."""
    if parse_epsg(src_crs) == parse_epsg(dst_crs):
        return float(left), float(bottom), float(right), float(top)
    us = np.linspace(left, right, densify)
    vs = np.linspace(bottom, top, densify)
    edge_x = np.concatenate([us, us, np.full(densify, left), np.full(densify, right)])
    edge_y = np.concatenate([np.full(densify, bottom), np.full(densify, top), vs, vs])
    tx, ty = transform_points(edge_x, edge_y, src_crs, dst_crs)
    return float(tx.min()), float(ty.min()), float(tx.max()), float(ty.max())

"""The port's own numpy copies of ``geo/crs.py`` and ``geo/transforms.py``,
its ``geo/assembly.py`` (through its own GeoTIFF writers) and
``inference/batch.py::get_img_bounds`` against the JAX package's on the
same inputs: the numpy copies exactly equal; the assembled (C)OGs decode
to the same array, transform, CRS and nodata as the JAX package's files,
read by either package's reader."""

import random

import numpy as np
import pytest

from satellite_computervision_tpu.geo import assembly as jassembly
from satellite_computervision_tpu.geo import crs as jcrs
from satellite_computervision_tpu.geo import read_geotiff as jax_read
from satellite_computervision_tpu.geo import transforms as jtr
from satellite_computervision_tpu.inference.batch import get_img_bounds as jax_bounds
from satellite_computervision_tpu.inference.mixer import MixerInfo as JaxMixer
from satellite_computervision_tpu_torch import geo as tgeo
from satellite_computervision_tpu_torch.geo import assembly as tassembly
from satellite_computervision_tpu_torch.geo import crs as tcrs
from satellite_computervision_tpu_torch.geo import read_geotiff as port_read
from satellite_computervision_tpu_torch.geo import transforms as ttr
from satellite_computervision_tpu_torch.inference.batch import get_img_bounds
from satellite_computervision_tpu_torch.inference.mixer import MixerInfo
from test_torch_deeplab import two_torch_threads  # noqa: F401

AFFINE = (10.0, 0.0, 500000.0, 0.0, -10.0, 3900000.0)


def _same(got, want):
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("src,dst", [
    ("EPSG:32617", "EPSG:4326"), ("EPSG:4326", "EPSG:32617"), ("EPSG:32733", "EPSG:4326"),
    ("EPSG:3857", "EPSG:32617"), ("EPSG:4326", "EPSG:3857"), ("epsg:32617", 32617),
])
def test_crs_copy_equal(src, dst):
    rng = np.random.default_rng(0)
    if tcrs.parse_epsg(src) == 4326:
        xs, ys = rng.uniform(-82, -80, 64), rng.uniform(-30, 40, 64)
    elif tcrs.parse_epsg(src) == 3857:
        xs, ys = rng.uniform(-9.1e6, -8.9e6, 64), rng.uniform(4.0e6, 4.5e6, 64)
    else:
        xs, ys = rng.uniform(3e5, 7e5, 64), rng.uniform(3e6, 4e6, 64)
    _same(tcrs.transform_points(xs, ys, src, dst), jcrs.transform_points(xs, ys, src, dst))
    box = (xs.min(), ys.min(), xs.max(), ys.max())
    for densify in (2, 21):
        _same(tcrs.transform_bounds(*box, src, dst, densify=densify),
              jcrs.transform_bounds(*box, src, dst, densify=densify))
    assert tcrs.parse_epsg(src) == jcrs.parse_epsg(src)


def test_crs_refusals_match():
    for bad in ("utm zone 17", "EPSG:abc"):
        for mod in (tcrs, jcrs):
            with pytest.raises(ValueError):
                mod.parse_epsg(bad)
    for mod in (tcrs, jcrs):
        with pytest.raises(ValueError, match="UTM"):
            mod.lonlat_to_utm(0.0, 0.0, 4326)


def test_transforms_copy_equal():
    rng = np.random.default_rng(1)
    t = ttr.Affine(*AFFINE)
    assert t == jtr.Affine(*AFFINE) and t.inverse() == jtr.Affine(*AFFINE).inverse()
    cols, rows = rng.uniform(0, 100, 32), rng.uniform(0, 100, 32)
    _same(ttr.pixel_to_geo(t, cols, rows), jtr.pixel_to_geo(AFFINE, cols, rows))
    xs, ys = jtr.pixel_to_geo(AFFINE, cols, rows)
    _same(ttr.geo_to_pixel(t, xs, ys), jtr.geo_to_pixel(AFFINE, xs, ys))
    poly = rng.uniform(0, 50, (7, 2))
    for inverse in (False, True):
        _same(ttr.convert_poly_coords(poly, t, inverse), jtr.convert_poly_coords(poly, t, inverse))
        _same(ttr.convert_pt((3.0, 4.0), t, inverse), jtr.convert_pt((3.0, 4.0), t, inverse))
    assert ttr.geo_transform_from_mixer(list(AFFINE) + [0, 0, 1]) == t
    assert ttr.convert_yolo_bbox((2, 10, 4, 12), (32, 32)) == jtr.convert_yolo_bbox(
        (2, 10, 4, 12), (32, 32))
    for h, w, tr in ((32, 48, AFFINE), (5, 7, (1.0, 0.5, 0.0, -0.25, -1.0, 3.0))):
        assert ttr.array_bounds(h, w, tr) == jtr.array_bounds(h, w, tr)
    assert ttr.make_window(10.6, 20.2, 16) == jtr.make_window(10.6, 20.2, 16)
    assert ttr.polygon_centroid(poly) == jtr.polygon_centroid(poly)
    assert ttr.win_jitter(100, 0.1, random.Random(3)) == jtr.win_jitter(100, 0.1, random.Random(3))
    xy = tuple(np.asarray(jtr.pixel_to_geo(AFFINE, poly[:, 0], poly[:, 1])).T.tolist())
    assert ttr.make_jittered_window(xy, t, 64, 0.1, random.Random(4)) == \
        jtr.make_jittered_window(xy, AFFINE, 64, 0.1, random.Random(4))
    with pytest.raises(ValueError, match="singular"):
        ttr.Affine(1.0, 2.0, 0.0, 2.0, 4.0, 0.0).inverse()


def test_geo_exports_the_transforms_names():
    names = ("Affine", "geo_transform_from_mixer", "pixel_to_geo", "geo_to_pixel",
             "convert_poly_coords", "convert_yolo_bbox", "make_window", "win_jitter",
             "make_jittered_window", "array_bounds")
    for name in names:
        assert name in tgeo.__all__ and getattr(tgeo, name) is getattr(ttr, name)


@pytest.mark.parametrize("dst", [None, "EPSG:4326", "EPSG:3857", "EPSG:32617"])
def test_get_img_bounds_equal(dst):
    kw = dict(total_patches=6, patches_per_row=3, patch_dimensions=(16, 16), affine=AFFINE,
              crs="EPSG:32617")
    got = get_img_bounds((32, 48, 1), MixerInfo(**kw), dst_crs=dst)
    assert got == jax_bounds((32, 48, 1), JaxMixer(**kw), dst_crs=dst)
    if dst == "EPSG:4326":
        (south, west), (north, east) = got
        assert -82 < west < east < -80 and 35 < south < north < 36


def _decoded(path):
    """(array, transform, crs, nodata) by both packages' readers, which
    must agree."""
    a, meta = port_read(path)
    b, jmeta = jax_read(path)
    np.testing.assert_array_equal(a, b)
    assert meta == jmeta
    return a, meta.get("transform"), meta.get("crs"), meta.get("nodata")


@pytest.mark.parametrize("layout,dtype,nodata,cog", [
    ("hwc", "float32", 255, True), ("chw", "float32", None, False),
    ("hwc", "uint8", 0, True), ("hwc", "float32", -1.0, False),
])
def test_numpy_to_raster_matches_jax(tmp_path, layout, dtype, nodata, cog):
    rng = np.random.default_rng(2)
    arr = rng.uniform(0, 200, (40, 56, 3)).astype(np.float32)
    if layout == "chw":
        arr = np.moveaxis(arr, -1, 0)
    mixer = {"transform": list(AFFINE), "crs": "EPSG:32617"}
    paths = [str(tmp_path / f"{n}.tif") for n in ("port", "jax")]
    tassembly.numpy_to_raster(arr, mixer, paths[0], dtype=dtype, nodata=nodata, cog=cog)
    jassembly.numpy_to_raster(arr, mixer, paths[1], dtype=dtype, nodata=nodata, cog=cog)
    got, want = _decoded(paths[0]), _decoded(paths[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == np.dtype(dtype) and got[0].shape == (40, 56, 3)
    assert got[1:] == want[1:] == (AFFINE, "EPSG:32617", None if nodata is None
                                   else float(nodata))


def test_arrays_to_cog_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    size = 16
    mixer = {"rows": 40, "cols": 36, "size": size, "transform": list(AFFINE),
             "crs": "EPSG:32617"}
    files = []
    for x in (0, 16, 32):
        for y in (0, 16, 32):
            shape = (size, size) if (x, y) == (16, 16) else (size, size, 1)
            f = tmp_path / f"{x}_{y}.npy"
            np.save(f, rng.normal(size=shape).astype(np.float32))
            files.append(str(f))
    paths = [str(tmp_path / f"{n}.tif") for n in ("port", "jax")]
    tassembly.arrays_to_cog(files, mixer, paths[0])
    jassembly.arrays_to_cog(files, mixer, paths[1])
    got, want = _decoded(paths[0]), _decoded(paths[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].shape == (40, 36, 1) and got[1:] == want[1:]
    for mod in (tassembly, jassembly):
        with pytest.raises(ValueError, match="no chip files"):
            mod.arrays_to_cog([], mixer, paths[0])

"""The port's copies of geo/geotiff.py and train/config.py against the JAX
package's originals: files written by one read back equal in the other,
and the serving presets carry the same values."""

import dataclasses

import numpy as np
import pytest

from satellite_computervision_tpu import geo as jax_geo
from satellite_computervision_tpu.train import config as jax_config
from satellite_computervision_tpu_torch import geo
from satellite_computervision_tpu_torch.train import config

TF = (10.0, 0.0, 500000.0, 0.0, -10.0, 4500000.0)


@pytest.mark.parametrize("dtype,compress,predictor", [
    (np.float32, "deflate", 1),
    (np.float32, "lzw", 3),
    (np.uint8, "lzw", 2),
    (np.uint16, "none", 1),
])
def test_write_geotiff_reads_back_in_jax(tmp_path, rng, dtype, compress, predictor):
    img = (rng.random((37, 29, 2)) * 200).astype(dtype)
    path = str(tmp_path / "a.tif")
    geo.write_geotiff(path, img, transform=TF, crs="EPSG:32617", nodata=0,
                      compress=compress, predictor=predictor)
    arr, meta = jax_geo.read_geotiff(path)
    np.testing.assert_array_equal(arr, img)
    assert meta["crs"] == "EPSG:32617" and tuple(meta["transform"]) == TF
    assert meta["nodata"] == 0.0


@pytest.mark.parametrize("compress", ["deflate", "lzw"])
def test_jax_geotiff_reads_back_in_port(tmp_path, rng, compress):
    img = rng.random((41, 33, 3)).astype(np.float32)
    path = str(tmp_path / "b.tif")
    jax_geo.write_geotiff(path, img, transform=TF, crs="EPSG:4326", compress=compress)
    arr, meta = geo.read_geotiff(path)
    np.testing.assert_array_equal(arr, img)
    assert meta["crs"] == "EPSG:4326"


def test_lzw_encoding_bit_equal_to_jax(rng):
    from satellite_computervision_tpu.geo import geotiff as jax_geotiff
    from satellite_computervision_tpu_torch.geo import geotiff

    data = bytes(rng.integers(0, 4, size=20000, dtype=np.uint8))
    enc = geotiff._lzw_encode(data)
    assert enc == jax_geotiff._lzw_encode(data)
    assert geotiff._lzw_decode(enc, len(data)) == data


def test_cog_and_stream_writer_read_back_in_jax(tmp_path, rng):
    img = rng.random((300, 280, 1)).astype(np.float32)
    cog = str(tmp_path / "c.tif")
    geo.write_cog(cog, img, transform=TF, crs="EPSG:32617", tile_size=128)
    np.testing.assert_array_equal(jax_geo.read_geotiff(cog)[0], img)
    over, _ = jax_geo.read_geotiff(cog, page=1)
    assert over.shape == (150, 140, 1)

    strip = str(tmp_path / "s.tif")
    with geo.GeoTiffStreamWriter(strip, 300, 280, 1, np.float32, transform=TF) as wr:
        for r0 in range(0, 300, 70):
            wr.write_rows(img[r0 : r0 + 70])
    np.testing.assert_array_equal(jax_geo.read_geotiff(strip)[0], img)


@pytest.mark.parametrize("name", ["solar", "parking", "change"])
def test_configs_match_jax(name):
    ours, theirs = config.CONFIGS[name], jax_config.CONFIGS[name]
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.serving_geometry == theirs.serving_geometry
    assert ours.training_geometry == theirs.training_geometry


def test_cog_stream_writer_matches_bulk_cog_and_jax(tmp_path, rng):
    """The port's GeoTiffCogStreamWriter fed uneven row blocks writes the
    pages of the bulk write_cog (base and mean-pooled overviews, per-level
    transform), readable by the JAX package, and windowed reads work."""
    img = rng.normal(size=(300, 280, 2)).astype(np.float32)
    bulk = str(tmp_path / "bulk.tif")
    jax_geo.write_cog(bulk, img, transform=TF, crs="EPSG:32617", tile_size=128, nodata=0.0)
    streamed = str(tmp_path / "streamed.tif")
    with geo.GeoTiffCogStreamWriter(streamed, 300, 280, 2, np.float32, transform=TF,
                                    crs="EPSG:32617", nodata=0.0, tile_size=128) as wr:
        y = 0
        for n in (1, 99, 64, 100, 36):  # uneven blocks spanning tile bands
            wr.write_rows(img[y : y + n])
            y += n
    page = 0
    while True:
        try:
            got, gmeta = jax_geo.read_geotiff(streamed, page=page)
        except IndexError:
            break
        want, wmeta = jax_geo.read_geotiff(bulk, page=page)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        assert gmeta["transform"] == wmeta["transform"] and gmeta["nodata"] == 0.0
        page += 1
    assert page >= 3  # base + at least two overview levels
    np.testing.assert_array_equal(geo.GeoTiffScene(streamed)[40:200, 33:257],
                                  img[40:200, 33:257])


def test_cog_stream_writer_int_decimation_lzw_predictor(tmp_path, rng):
    """Integer overviews decimate (write_cog's rule); the LZW + predictor 2
    stream (GDAL's COG recipe, native LZW codec) reads back in JAX."""
    img = rng.integers(0, 255, (90, 70, 1), np.uint8)
    path = str(tmp_path / "u8.tif")
    with geo.GeoTiffCogStreamWriter(path, 90, 70, 1, np.uint8, tile_size=32,
                                    compress="lzw", predictor=2, overview_levels=1) as wr:
        wr.write_rows(img)
    base, _ = jax_geo.read_geotiff(path, page=0)
    np.testing.assert_array_equal(base, img)
    over, _ = jax_geo.read_geotiff(path, page=1)
    np.testing.assert_array_equal(over, img[: 90 // 2 * 2 : 2, : 70 // 2 * 2 : 2])


def test_cog_stream_writer_contract(tmp_path):
    wr = geo.GeoTiffCogStreamWriter(str(tmp_path / "a.tif"), 10, 4, 1, np.uint8)
    wr.write_rows(np.zeros((6, 4, 1), np.uint8))
    with pytest.raises(ValueError, match="overflow"):
        wr.write_rows(np.zeros((5, 4, 1), np.uint8))
    with pytest.raises(ValueError, match="expected 10"):
        wr.close()
    with pytest.raises(ValueError, match="multiples of 16"):
        geo.GeoTiffCogStreamWriter(str(tmp_path / "b.tif"), 10, 4, 1, np.uint8, tile_size=100)
    path = str(tmp_path / "c.tif")
    with pytest.raises(RuntimeError):
        with geo.GeoTiffCogStreamWriter(path, 10, 4, 1, np.uint8):
            raise RuntimeError("x")
    with pytest.raises(Exception):
        geo.GeoTiffScene(path)  # aborted -> unfinalized


def test_cog_stream_writer_bigtiff_matches_classic(tmp_path, rng):
    img = rng.normal(size=(300, 280, 1)).astype(np.float32)
    pages = {}
    for big in (False, True):
        path = str(tmp_path / f"big{big}.tif")
        with geo.GeoTiffCogStreamWriter(path, 300, 280, 1, np.float32, transform=TF,
                                        tile_size=128, bigtiff=big) as wr:
            wr.write_rows(img)
        with open(path, "rb") as f:
            assert (f.read(4) == b"II+\x00") == big
        pages[big] = [jax_geo.read_geotiff(path, page=p)[0] for p in range(3)]
    for a, b in zip(pages[False], pages[True]):
        np.testing.assert_array_equal(a, b)


def test_geotiff_scene_matches_jax_lazily(tmp_path, rng):
    img = rng.normal(size=(130, 70, 3)).astype(np.float32)
    path = str(tmp_path / "lazy.tif")
    with jax_geo.GeoTiffStreamWriter(path, 130, 70, 3, np.float32, transform=TF,
                                     crs="EPSG:32617", nodata=-9.0, rows_per_strip=16) as wr:
        wr.write_rows(img)
    ours, theirs = geo.GeoTiffScene(path), jax_geo.GeoTiffScene(path)
    assert ours.lazy and ours.shape == theirs.shape and ours.dtype == theirs.dtype
    assert ours.nodata == theirs.nodata == -9.0 and ours.meta == theirs.meta
    for rows in (slice(0, 1), slice(17, 95), slice(120, 130), slice(None)):
        np.testing.assert_array_equal(ours[rows], theirs[rows])

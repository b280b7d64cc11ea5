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


@pytest.mark.parametrize("name", ["solar", "parking"])
def test_configs_match_jax(name):
    ours, theirs = config.CONFIGS[name], jax_config.CONFIGS[name]
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.serving_geometry == theirs.serving_geometry

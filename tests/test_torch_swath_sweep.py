"""The port's swath codec sweep against ``examples/swath_codec_sweep.py``
on a tiny swath (256 x 192 x 4 uint16, kernel 64, buffer 16, filters
4/8): the synthesized COGs decode to the same pixels and are the same
bytes, the overview calibration is equal, the served probabilities of a
bridged, folded U-Net match the JAX engine's within 1e-5 (the uint8 maps
within one count where a product sits on a rounding edge), and the
twin's records carry the JAX script's keys and values."""

import argparse
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from satellite_computervision_tpu.inference import TiledInferenceEngine as JaxEngine
from satellite_computervision_tpu.models import UNet as JaxUNet
from satellite_computervision_tpu.models import fold_unet_variables
from satellite_computervision_tpu_torch import swath_codec_sweep as twin
from satellite_computervision_tpu_torch.geo import GeoTiffScene
from satellite_computervision_tpu_torch.models import UNet, flax_to_torch, fold_unet
from test_torch_convergence import load_example
from test_torch_deeplab import random_variables, two_torch_threads  # noqa: F401

H, W, C, KERNEL, BUFFER = 256, 192, 4, 64, 16


@pytest.fixture(scope="module")
def jswath():
    return load_example("swath_codec_sweep")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory, jswath):
    """The same scene synthesized by both (tile 64, so the COG holds
    overview pages)."""
    root = tmp_path_factory.mktemp("swath")
    paths = {}
    for name, mod in (("port", twin), ("jax", jswath)):
        paths[name] = str(root / f"{name}.tif")
        mod.synthesize_scene(paths[name], H, W, C, seed=3, band_rows=100, tile_size=64)
    return paths


def test_synthesized_scenes_are_equal(scenes):
    got = np.asarray(GeoTiffScene(scenes["port"]))
    want = np.asarray(GeoTiffScene(scenes["jax"]))
    assert got.dtype == np.uint16 and got.shape == (H, W, C)
    assert np.array_equal(got, want)
    with open(scenes["port"], "rb") as a, open(scenes["jax"], "rb") as b:
        assert a.read() == b.read()  # both encoders are the native LZW


@pytest.mark.parametrize("percentiles", [(1, 99), (5, 95)])
def test_overview_calibration_is_equal(scenes, jswath, percentiles):
    lo, hi, page = twin.overview_calibration(scenes["port"], percentiles)
    jlo, jhi, jpage = jswath.overview_calibration(scenes["jax"], percentiles)
    assert page == jpage and page > 0
    assert lo.dtype == jlo.dtype and np.array_equal(lo, jlo) and np.array_equal(hi, jhi)


def test_served_scene_matches_jax(scenes, jswath, tmp_path):
    """One scene, banded (2 chip rows + buffer), hann, the collection
    calibration on the device, from bridged weights folded by each side."""
    args = argparse.Namespace(bands=C, filters=[4, 8], kernel=KERNEL, buffer=BUFFER, batch=4,
                              seed=0)
    max_rows = 2 * KERNEL + BUFFER
    lo, hi, _ = twin.overview_calibration(scenes["port"])

    jmodel = JaxUNet(n_classes=1, filters=(4, 8), factors=(2, 2), head="sigmoid",
                     dtype=jnp.float32)
    # random weights and BN statistics, so the probabilities spread over
    # (0, 1) rather than sitting at 0.5 as a fresh init's do
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 80, 80, C)))
    variables = random_variables(shapes, np.random.default_rng(4))
    fmodel, fvars = fold_unet_variables(jmodel, variables)
    lo_d, hi_d = jnp.asarray(lo), jnp.asarray(hi)

    def jax_engine(output_transform):
        return JaxEngine(
            lambda chips: fmodel.apply(fvars, chips)["probs"], kernel=KERNEL, buffer=BUFFER,
            batch_size=4, out_channels=1, blend="hann", index_mode="grid", max_rows=max_rows,
            preprocess_fn=lambda s: jnp.clip((s.astype(jnp.float32) - lo_d)
                                             / jnp.maximum(hi_d - lo_d, 1e-6), 0, 1),
            output_transform=output_transform)

    jeng = jax_engine(lambda pr: (pr * 255.0).astype(jnp.uint8))

    model = UNet(C, n_classes=1, filters=(4, 8), factors=(2, 2), head="sigmoid")
    model.load_state_dict(flax_to_torch(variables["params"], variables["batch_stats"], model))
    served = fold_unet(model.eval())
    teng = twin.build_engine(served, args, lo, hi, torch.device("cpu"), max_rows)

    jout, tout = str(tmp_path / "jax.tif"), str(tmp_path / "port.tif")
    jeng.predict_scene_to_geotiff(GeoTiffScene(scenes["jax"]), jout, transform=twin.TRANSFORM,
                                  crs="EPSG:32617", cog=True)
    teng.predict_scene_to_geotiff(GeoTiffScene(scenes["port"]), tout,
                                  transform=twin.TRANSFORM, crs="EPSG:32617", cog=True)
    got, want = np.asarray(GeoTiffScene(tout)), np.asarray(GeoTiffScene(jout))
    assert got.dtype == np.uint8 and got.shape == (H, W, 1)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3

    teng.output_transform = None
    jprob = np.asarray(jax_engine(None).predict_scene(GeoTiffScene(scenes["jax"])))
    tprob = teng.predict_scene(GeoTiffScene(scenes["port"])).numpy()
    np.testing.assert_allclose(tprob, jprob, atol=1e-5)
    assert 0.0 <= tprob.min() and tprob.max() <= 1.0 and tprob.std() > 0.01


def test_sweep_records_match_jax(jswath, tmp_path, capsys):
    """Both scripts end to end at the tiny size: the port's per-scene and
    summary records hold every JAX key with the same geometry, plus the
    launches and the resident set after the model."""
    flags = ["--scenes", "2", "--height", str(H), "--width", str(W), "--kernel", str(KERNEL),
             "--buffer", str(BUFFER), "--filters", "4", "8"]
    jlog, tlog = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    jswath.main(flags + ["--log", str(jlog), "--dir", str(tmp_path / "j")])
    summary = twin.main(flags + ["--log", str(tlog), "--dir", str(tmp_path / "t"),
                                 "--device", "cpu"])
    jrecs = [json.loads(line) for line in jlog.read_text().splitlines()]
    trecs = [json.loads(line) for line in tlog.read_text().splitlines()]
    assert len(jrecs) == len(trecs) == 3
    for j, t in zip(jrecs[:2], trecs[:2]):
        assert set(t) == set(j) | {"hann_stitch_launches"}
        for key in ("scene", "height", "width", "bands", "raw_mb", "in_mb", "calib_page",
                    "kernel", "buffer", "max_rows"):
            assert t[key] == j[key], key
        assert t["platform"] == "cpu" and t["hann_stitch_launches"] == 0  # CPU: plain version
    js, ts = jrecs[2]["summary"], trecs[2]["summary"]
    assert ts == summary
    assert set(ts) == set(js) | {"hann_stitch_launches", "rss_model_mb",
                                 "rss_growth_after_model_mb"}
    for key in ("swath_scenes", "scene_mpix", "raw_mb_per_scene", "band_mb", "config"):
        assert ts[key] == js[key], key
    assert "SWATH " in capsys.readouterr().out
    assert not list((tmp_path / "t").iterdir())  # inputs and outputs removed without --keep

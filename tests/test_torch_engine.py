"""The port's TiledInferenceEngine (inference/tiles.py), GeoTIFF output and
predict CLI against the JAX package's engine with the same (bridged)
weights, on the CPU. Tolerance atol 1e-5 on probabilities: float32 convs
summed in another order."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from satellite_computervision_tpu.geo import read_geotiff
from satellite_computervision_tpu.inference import TiledInferenceEngine as JaxEngine
from satellite_computervision_tpu.models import UNet as JaxUNet
from satellite_computervision_tpu_torch import predict as cli
from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
from satellite_computervision_tpu_torch.models import UNet, flax_to_torch
from satellite_computervision_tpu_torch.train.checkpoint import save_checkpoint

ENGINE = dict(kernel=16, buffer=8, batch_size=4)
MODEL = dict(n_classes=1, filters=(4, 8), factors=(2, 2), head="sigmoid",
             space_to_depth=True)


@pytest.fixture
def bridged(rng):
    """(JAX UNet, its variables, the port's UNet with the same weights)."""
    jmodel = JaxUNet(**MODEL)
    v = jax.device_get(jmodel.init(jax.random.key(0), jnp.zeros((1, 24, 24, 6))))
    v["params"] = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=np.shape(a)) * 0.3).astype(np.float32), v["params"])
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (np.abs(rng.normal(size=np.shape(a))) + 0.3).astype(np.float32),
        v["batch_stats"])
    model = UNet(6, **MODEL).eval()
    model.load_state_dict(flax_to_torch(v["params"], v["batch_stats"], model))
    return jmodel, v, model


@pytest.mark.parametrize("mode", ["grid", "reference"])
@pytest.mark.parametrize("blend", ["overwrite", "hann"])
def test_engine_matches_jax(rng, bridged, blend, mode):
    jmodel, v, model = bridged
    scene = rng.normal(size=(70, 90, 6)).astype(np.float32)
    got = TiledInferenceEngine.from_model(
        model, blend=blend, index_mode=mode, device="cpu", **ENGINE
    ).predict_scene(scene).numpy()
    assert got.shape == (70, 90, 1) and got.dtype == np.float32
    for pallas_blend in ([False, "interpret"] if blend == "hann" else [False]):
        want = np.asarray(JaxEngine.from_model(
            jmodel, v, blend=blend, index_mode=mode, pallas_blend=pallas_blend, **ENGINE
        ).predict_scene(scene))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_engine_preprocess_and_output_transform(rng, bridged):
    jmodel, v, model = bridged
    scene = rng.integers(0, 10000, size=(40, 40, 6)).astype(np.uint16)
    got = TiledInferenceEngine.from_model(
        model, blend="hann", device="cpu", **ENGINE,
        preprocess_fn=lambda s: s.float() / 10000.0,
        output_transform=lambda p: (p * 255.0).to(torch.uint8),
    ).predict_scene(scene).numpy()
    want = np.asarray(JaxEngine.from_model(
        jmodel, v, blend="hann", **ENGINE,
        preprocess_fn=lambda s: s.astype(jnp.float32) / 10000.0,
        output_transform=lambda p: (p * 255.0).astype(jnp.uint8),
    ).predict_scene(scene))
    assert got.dtype == np.uint8
    # a probability within float noise of a /255 step may land one lower
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("mode", ["grid", "reference"])
def test_engine_small_scene_returns_zeros(bridged, mode):
    """A scene smaller than kernel + buffer: zeros of the scene's shape in
    reference mode (no chip fits), one padded chip in grid mode."""
    jmodel, v, model = bridged
    scene = np.ones((20, 20, 6), np.float32)
    got = TiledInferenceEngine.from_model(
        model, index_mode=mode, device="cpu", **ENGINE).predict_scene(scene).numpy()
    want = np.asarray(JaxEngine.from_model(
        jmodel, v, index_mode=mode, **ENGINE).predict_scene(scene))
    assert got.shape == (20, 20, 1)
    if mode == "reference":
        assert not got.any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_engine_rejects_bad_geometry():
    with pytest.raises(ValueError):
        TiledInferenceEngine(lambda c: c, kernel=16, buffer=32, blend="hann", device="cpu")
    with pytest.raises(ValueError):
        TiledInferenceEngine(lambda c: c, kernel=16, buffer=7, device="cpu")
    with pytest.raises(ValueError):
        TiledInferenceEngine(lambda c: c, blend="mean", device="cpu")


def test_predict_scene_to_geotiff_reads_back_in_jax(tmp_path, rng, bridged):
    _, _, model = bridged
    scene = rng.normal(size=(50, 60, 6)).astype(np.float32)
    engine = TiledInferenceEngine.from_model(model, blend="hann", device="cpu", **ENGINE)
    path = str(tmp_path / "pred.tif")
    tf = (10.0, 0.0, 500000.0, 0.0, -10.0, 4500000.0)
    assert engine.predict_scene_to_geotiff(scene, path, transform=tf,
                                           crs="EPSG:32617") == path
    arr, meta = read_geotiff(path)
    np.testing.assert_array_equal(arr, engine.predict_scene(scene).numpy())
    assert meta["crs"] == "EPSG:32617" and tuple(meta["transform"]) == tf


@pytest.mark.parametrize("uint8", [False, True], ids=["probs", "uint8"])
def test_cli_scene_cpu_end_to_end(tmp_path, rng, bridged, uint8):
    _, _, model = bridged
    save_checkpoint(str(tmp_path / "ckpt"), model, {"step": 3})
    scene = rng.normal(size=(40, 56, 6)).astype(np.float32)
    np.save(tmp_path / "scene.npy", scene)
    out = str(tmp_path / "pred.tif")
    argv = ["scene", "--input", str(tmp_path / "scene.npy"), "--ckpt",
            str(tmp_path / "ckpt"), "--output", out, "--kernel", "16", "--buffer", "8",
            "--batch-size", "4", "--fold-bn", "--device", "cpu", "--crs", "EPSG:32617",
            "--transform", "10", "0", "500000", "0", "-10", "4500000"]
    assert cli.main(argv + (["--uint8"] if uint8 else [])) == out
    arr, meta = read_geotiff(out)
    want = TiledInferenceEngine.from_model(
        model, blend="hann", device="cpu", **ENGINE).predict_scene(scene).numpy()
    assert arr.shape == (40, 56, 1) and meta["crs"] == "EPSG:32617"
    if uint8:
        assert arr.dtype == np.uint8
        assert np.abs(arr.astype(int) - (want * 255.0).astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(arr, want, rtol=0, atol=1e-5)

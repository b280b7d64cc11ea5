"""The port reads the JAX package's msgpack checkpoints without msgpack,
flax or jax: its decoder (train/flax_msgpack.py) against
``flax.serialization`` at atol 0, and ``predict.load_model`` / the
``predict`` CLI serving a full-width solar checkpoint with the same
probabilities as the JAX engine (atol 1e-5, float32, CPU)."""

import dataclasses
import json
import os

import flax.serialization
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from satellite_computervision_tpu.geo import read_geotiff
from satellite_computervision_tpu.inference import TiledInferenceEngine as JaxEngine
from satellite_computervision_tpu.models import UNet as JaxUNet
from satellite_computervision_tpu.train import save_checkpoint
from satellite_computervision_tpu.train.trainer import TrainState
from satellite_computervision_tpu_torch import predict as cli
from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
from satellite_computervision_tpu_torch.train import flax_msgpack
from satellite_computervision_tpu_torch.train.checkpoint import read_flax_checkpoint
from satellite_computervision_tpu_torch.train.config import SOLAR_CONFIG

ENGINE = dict(kernel=32, buffer=32, batch_size=4, blend="hann")  # 64² chips: S2D x 2^5


def _assert_tree_equal(got, want, path="root"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert isinstance(got, type(want)) or isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def _train_state(model, rng, tx, shape):
    """A JAX TrainState with random weights and BN statistics."""
    v = jax.device_get(jax.jit(model.init)(jax.random.key(0), jnp.zeros(shape)))
    params = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=np.shape(a)) * 0.3).astype(np.float32), v["params"])
    stats = jax.tree_util.tree_map(
        lambda a: (np.abs(rng.normal(size=np.shape(a))) + 0.3).astype(np.float32),
        v["batch_stats"])
    return TrainState(step=jnp.asarray(7, jnp.int32), params=params, batch_stats=stats,
                      opt_state=tx.init(params), apply_fn=model.apply, tx=tx)


def test_decoder_matches_flax_on_a_saved_train_state(tmp_path, rng):
    model = JaxUNet(n_classes=2, filters=(4, 8), factors=(2, 2), head="softmax")
    state = _train_state(model, rng, optax.adam(1e-3), (1, 16, 16, 3))
    save_checkpoint(str(tmp_path), state, metrics={"mean_iou": 0.5}, step=7)
    tree, meta = read_flax_checkpoint(str(tmp_path))
    with open(tmp_path / "state.msgpack", "rb") as f:
        want = flax.serialization.msgpack_restore(f.read())
    _assert_tree_equal(tree, want)
    assert int(tree["step"]) == 7
    # adam's state tuple arrives as a map with keys "0", "1", ...
    assert set(tree["opt_state"]) == {"0", "1"}
    with open(tmp_path / "meta.json") as f:
        assert meta == json.load(f) == {"step": 7, "metrics": {"mean_iou": 0.5}}


def test_decoder_reads_bfloat16_exactly_and_scalars(rng):
    leaf = jnp.asarray(rng.normal(size=(3, 5)).astype(np.float32), jnp.bfloat16)
    blob = flax.serialization.to_bytes({"w": leaf, "s": np.float32(2.5), "i": 3,
                                        "t": (1.5, None, True, "x")})
    got = flax_msgpack.restore(blob)
    assert got["w"].dtype == np.float32
    np.testing.assert_array_equal(got["w"], np.asarray(leaf.astype(jnp.float32)))
    assert got["s"] == np.float32(2.5) and got["i"] == 3
    assert got["t"] == {"0": 1.5, "1": None, "2": True, "3": "x"}


def test_decoder_rejects_what_it_does_not_read(monkeypatch):
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    chunked = flax.serialization.msgpack_serialize({"a": np.arange(100, dtype=np.float32)})
    monkeypatch.undo()
    with pytest.raises(ValueError, match="chunked array"):
        flax_msgpack.restore(chunked)
    with pytest.raises(ValueError, match="ext type 5"):
        flax_msgpack.restore(b"\x81\xa1a\xd4\x05\x00")  # {"a": fixext1 of type 5}
    with pytest.raises(ValueError, match="complex"):
        flax_msgpack.restore(flax.serialization.to_bytes({"c": 1 + 2j}))
    good = flax.serialization.to_bytes({"w": np.ones((4, 4), np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.restore(good[:-3])
    with pytest.raises(ValueError, match="trailing"):
        flax_msgpack.restore(good + b"\xc0")
    with pytest.raises(ValueError, match="invalid msgpack marker"):
        flax_msgpack.restore(b"\xc1")


@pytest.fixture(scope="module")
def solar_ckpt(tmp_path_factory):
    """A full-width solar U-Net (S2D stem) saved by the JAX package, and
    its variables."""
    rng = np.random.default_rng(7)
    model = JaxUNet(n_classes=1, head="sigmoid", threshold=SOLAR_CONFIG.threshold,
                    space_to_depth=True)
    state = _train_state(model, rng, optax.sgd(1e-3), (1, 64, 64, 6))
    # small He-scale weights so the probabilities stay away from 0 and 1
    state = state.replace(params=jax.tree_util.tree_map(
        lambda a: a * (0.1 if a.ndim == 4 else 0.01), state.params))
    ckpt = tmp_path_factory.mktemp("jax_solar")
    save_checkpoint(str(ckpt / "best"), state, step=7)
    scene = rng.uniform(0.0, 0.4, size=(80, 100, 6)).astype(np.float32)
    want = np.asarray(JaxEngine.from_model(
        model, {"params": state.params, "batch_stats": state.batch_stats},
        **ENGINE).predict_scene(scene))
    return str(ckpt), scene, want


def test_load_model_serves_jax_checkpoint(solar_ckpt, capsys):
    ckpt, scene, want = solar_ckpt
    model = cli.load_model(ckpt, torch.device("cpu"), fold_bn=True, cfg=SOLAR_CONFIG)
    assert model.space_to_depth and "note" not in capsys.readouterr().out
    got = TiledInferenceEngine.from_model(model, device="cpu", **ENGINE).predict_scene(scene)
    assert 0.02 < want.min() and want.max() < 0.98  # not saturated
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_load_model_retries_the_other_stem(solar_ckpt, capsys):
    """A config whose stem differs from the checkpoint's: built once with
    the config's stem, then once flipped (the JAX CLI's retry); an explicit
    stem does not retry."""
    ckpt, scene, want = solar_ckpt
    plain = dataclasses.replace(SOLAR_CONFIG, space_to_depth=False)
    model = cli.load_model(ckpt, torch.device("cpu"), cfg=plain)
    assert model.space_to_depth
    assert "serving space_to_depth=True" in capsys.readouterr().out
    got = TiledInferenceEngine.from_model(model, device="cpu", **ENGINE).predict_scene(scene)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    with pytest.raises((KeyError, RuntimeError)):
        cli.load_model(ckpt, torch.device("cpu"), s2d=False, cfg=SOLAR_CONFIG)


def test_cli_serves_jax_checkpoint(solar_ckpt, tmp_path):
    ckpt, scene, want = solar_ckpt
    np.save(tmp_path / "scene.npy", scene)
    out = str(tmp_path / "pred.tif")
    assert os.path.exists(os.path.join(ckpt, "best", "state.msgpack"))
    cli.main(["scene", "--input", str(tmp_path / "scene.npy"), "--ckpt", ckpt,
              "--output", out, "--kernel", "32", "--buffer", "32", "--batch-size", "4",
              "--fold-bn", "--device", "cpu", "--predictor", "3"])
    arr, _ = read_geotiff(out)
    assert arr.shape == (80, 100, 1) and arr.dtype == np.float32
    np.testing.assert_allclose(arr, want, rtol=0, atol=1e-5)

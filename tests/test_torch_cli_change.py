"""Change detection through the port's CLIs, on the CPU at small sizes:
``predict change`` against the JAX package's ``scripts/predict.py change``
on one JAX ``state.msgpack`` checkpoint of a small Siamese U-Net (both
zoos monkeypatched to the same small widths, float32) and the same
before/after pair (probabilities within 1e-5; uint8 outputs within one
step), its exits, ``train --config change`` on npy chips whose
``model.pt`` ``predict change`` serves, the siamese zoo family against
the JAX one, and a checkpoint written before ``model.pt`` recorded its
architecture."""

import dataclasses
import importlib.util
import pathlib

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from satellite_computervision_tpu import testing as fx
from satellite_computervision_tpu.geo import read_geotiff, write_geotiff
from satellite_computervision_tpu.models import SiameseUNet as JaxSiamese
from satellite_computervision_tpu.train import save_checkpoint as jax_save_checkpoint
from satellite_computervision_tpu.train import zoo as jzoo
from satellite_computervision_tpu.train.config import CHANGE_CONFIG as JAX_CHANGE
from satellite_computervision_tpu.train.trainer import TrainState
from satellite_computervision_tpu_torch import predict as cli
from satellite_computervision_tpu_torch.models import SiameseUNet, UNet
from satellite_computervision_tpu_torch.train import __main__ as train_cli
from satellite_computervision_tpu_torch.train import zoo
from satellite_computervision_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from satellite_computervision_tpu_torch.train.config import CHANGE_CONFIG

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(filters=(4,), factors=(2,))  # one level: the model itself is tested in test_torch_siamese.py
GEOM = ["--kernel", "16", "--buffer", "8", "--batch-size", "4"]
TF = (10.0, 0.0, 500000.0, 0.0, -10.0, 4500000.0)


def _jax_cli():
    spec = importlib.util.spec_from_file_location("jax_predict_cli", ROOT / "scripts" / "predict.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def small_change(monkeypatch):
    """The change preset cut for the CPU (16² chips, 4 per batch) and both
    zoos' siamese family at the same small widths, in float32."""
    jcli = _jax_cli()
    small = dataclasses.replace(CHANGE_CONFIG, kernel_size=16, kernel_buffer=8, batch_size=4)
    jsmall = dataclasses.replace(JAX_CHANGE, kernel_size=16, kernel_buffer=8, batch_size=4)
    monkeypatch.setitem(cli.CONFIGS, "change", small)  # the train CLI's dict too
    monkeypatch.setitem(jcli.CONFIGS, "change", jsmall)
    fam, jfam = zoo.FAMILIES["siamese"], jzoo.FAMILIES["siamese"]
    monkeypatch.setitem(zoo.FAMILIES, "siamese", dataclasses.replace(
        fam, build=lambda cfg, **kw: fam.build(cfg, **SMALL, **kw)))
    monkeypatch.setitem(jzoo.FAMILIES, "siamese", dataclasses.replace(
        jfam, build=lambda cfg, **kw: jfam.build(cfg, **SMALL, **{**kw, "dtype": jnp.float32})))
    return jcli


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A small JAX Siamese U-Net's train state, saved by the JAX package
    (weights and BN statistics from a seed, scaled so the probabilities
    stay inside (0, 1))."""
    rng = np.random.default_rng(11)
    model = JaxSiamese(**SMALL)
    x = jnp.zeros((1, 16, 16, 4))
    v = jax.device_get(jax.jit(model.init)(jax.random.key(0), x, x))
    params = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=np.shape(a)) * 0.5).astype(np.float32), v["params"])
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32), v["batch_stats"])
    tx = optax.adam(1e-3)
    state = TrainState(step=jnp.asarray(5, jnp.int32), params=params, batch_stats=stats,
                       opt_state=tx.init(params), apply_fn=model.apply, tx=tx)
    ckpt = tmp_path_factory.mktemp("jax_change")
    jax_save_checkpoint(str(ckpt / "best"), state, step=5)
    return str(ckpt)


def _pair(rng, h=60, w=50, nodata_cols=24):
    before = rng.uniform(0.0, 0.5, (h, w, 4)).astype(np.float32)
    after = before + rng.normal(0.0, 0.02, before.shape).astype(np.float32)
    after[20:40, 25:45] += 0.4  # the change
    before[:, :nodata_cols] = 0.0
    after[:, :nodata_cols] = 0.0
    return before, after


def _run_both(jcli, tmp_path, ckpt, before_path, after_path, flags):
    ours, theirs = str(tmp_path / "ours.tif"), str(tmp_path / "theirs.tif")
    base = ["change", "--config", "change", "--input-before", before_path,
            "--input-after", after_path, "--ckpt", ckpt, *GEOM, *flags]
    assert cli.main(base + ["--device", "cpu", "--output", ours]) == ours
    jcli.main(base + ["--output", theirs])
    got, got_meta = read_geotiff(ours)
    want, want_meta = read_geotiff(theirs)
    return got, want, got_meta, want_meta


@pytest.mark.parametrize("flags", [
    [],
    ["--blend", "overwrite"],
    ["--nodata", "0"],
    ["--nodata", "0", "--max-rows", "40"],
    ["--tile-mode", "whole"],
    ["--nodata", "0", "--uint8", "--predictor", "2", "--cog"],
], ids=["hann", "overwrite", "nodata", "banded", "whole", "uint8-cog"])
def test_predict_change_matches_jax_cli(small_change, jax_ckpt, tmp_path, rng, flags):
    before, after = _pair(rng)
    np.save(tmp_path / "before.npy", before)
    np.save(tmp_path / "after.npy", after)
    got, want, got_meta, _ = _run_both(
        small_change, tmp_path, jax_ckpt, str(tmp_path / "before.npy"),
        str(tmp_path / "after.npy"), flags + ["--crs", "EPSG:32617",
                                              "--transform", *map(str, TF)])
    assert got.shape == want.shape == (60, 50, 1) and got.dtype == want.dtype
    assert got_meta["crs"] == "EPSG:32617" and tuple(got_meta["transform"]) == TF
    if "--uint8" in flags:
        assert got.dtype == np.uint8
        # a probability within float noise of a /255 step may land one lower
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        assert want.std() > 1e-3 and 0.0 < want.max() < 1.0  # varied, not saturated
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if "--nodata" in flags:
        # the first chip column's window (scene columns -4..19) is all
        # nodata: culled; only it reaches columns 0..11
        assert not got[:, :12].any() and got[:, 24:].all()


def test_nodata_defaults_to_the_before_scenes_tag(small_change, jax_ckpt, tmp_path, rng):
    before, after = _pair(rng)
    write_geotiff(str(tmp_path / "before.tif"), before, transform=TF, crs="EPSG:32617",
                  nodata=0.0)
    np.save(tmp_path / "after.npy", after)
    got, want, got_meta, want_meta = _run_both(
        small_change, tmp_path, jax_ckpt, str(tmp_path / "before.tif"),
        str(tmp_path / "after.npy"), [])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert not got[:, :12].any()  # culled by the before scene's tag
    # georeferencing from the before scene; no nodata tag, as the JAX CLI
    assert tuple(got_meta["transform"]) == TF and got_meta["crs"] == "EPSG:32617"
    assert got_meta.get("nodata") is None and want_meta.get("nodata") is None


def test_predict_change_exits(small_change, jax_ckpt, tmp_path, rng):
    before, _ = _pair(rng)
    np.save(tmp_path / "before.npy", before)
    np.save(tmp_path / "small.npy", before[:40])
    args = ["change", "--config", "change", "--ckpt", jax_ckpt, "--device", "cpu", *GEOM]
    for extra in ([], ["--input-before", str(tmp_path / "before.npy")]):
        with pytest.raises(SystemExit, match="needs --input-before and --input-after"):
            cli.main(args + extra)
    with pytest.raises(SystemExit, match="scene shapes differ"):
        cli.main(args + ["--input-before", str(tmp_path / "before.npy"),
                         "--input-after", str(tmp_path / "small.npy")])
    pair = ["--input-before", str(tmp_path / "before.npy"),
            "--input-after", str(tmp_path / "before.npy")]
    with pytest.raises(SystemExit, match="--fold-bn currently supports the unet family"):
        cli.main(args + pair + ["--fold-bn"])
    with pytest.raises(SystemExit, match="change mode serves the siamese family, not deeplab"):
        cli.main(args + pair + ["--model", "deeplab"])
    with pytest.raises(SystemExit, match="change mode serves the siamese family"):
        cli.main(args + pair + ["--model", "unet"])
    assert not (tmp_path / "change.tif").exists()


def test_change_entry_points_default_to_cuda(tmp_path, monkeypatch, rng):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before, after = _pair(rng)
    np.save(tmp_path / "before.npy", before)
    np.save(tmp_path / "after.npy", after)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["change", "--config", "change", "--input-before", str(tmp_path / "before.npy"),
                  "--input-after", str(tmp_path / "after.npy"), "--ckpt", str(tmp_path)])
    tree = fx.make_siamese_chip_tree(str(tmp_path / "chips"), n_chips=2, dim=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--config", "change", "--before", tree["before"][0],
                        "--after", tree["after"][0], "--labels", tree["label"][0],
                        "--ckpt", str(tmp_path / "run")])
    assert not (tmp_path / "run").exists()


def test_train_change_then_predict_change(small_change, tmp_path, rng):
    """``train --config change`` on 40² npy chips (trimmed to the 16²
    training tile), then ``predict change`` serves its model.pt."""
    chips = tmp_path / "chips"
    fx.make_siamese_chip_tree(str(chips), n_chips=8, dim=40)
    ckpt = str(tmp_path / "run")
    trainer = train_cli.main([
        "--config", "change", "--before", str(chips / "before/*.npy"),
        "--after", str(chips / "after/*.npy"), "--labels", str(chips / "label/*.npy"),
        "--ckpt", ckpt, "--epochs", "2", "--device", "cpu"])
    # steps per epoch default to the dataset's length: 8 chips / batch 4
    assert trainer.state.step == 4 and len(trainer.history) == 2
    assert all(np.isfinite(r["train"]["loss"]) for r in trainer.history)
    assert "val" not in trainer.history[0]
    model = trainer.state.model
    assert isinstance(model, SiameseUNet) and model.kwargs["bn_momentum"] == 0.99
    blob = torch.load(tmp_path / "run" / "best" / "model.pt", weights_only=True)
    assert blob["arch"] == "siamese"

    before, after = _pair(rng)
    np.save(tmp_path / "before.npy", before)
    np.save(tmp_path / "after.npy", after)
    out = cli.main(["change", "--config", "change", "--input-before", str(tmp_path / "before.npy"),
                    "--input-after", str(tmp_path / "after.npy"), "--ckpt", ckpt,
                    "--device", "cpu", "--output", str(tmp_path / "change.tif"), *GEOM])
    pred, _ = read_geotiff(out)
    assert pred.shape == (60, 50, 1) and np.isfinite(pred).all()
    assert 0.0 <= pred.min() and pred.max() <= 1.0
    with pytest.raises(SystemExit, match="convlstm needs --series npy glob"):
        train_cli.main(["--config", "change", "--model", "convlstm", "--device", "cpu"])
    with pytest.raises(SystemExit, match="needs --before/--after/--labels"):
        train_cli.main(["--config", "change", "--device", "cpu"])


def test_zoo_siamese_family_matches_jax():
    fam, jfam = zoo.get_family("siamese"), jzoo.get_family("siamese")
    inputs, jinputs = fam.example_inputs(CHANGE_CONFIG), jfam.example_inputs(JAX_CHANGE)
    assert len(inputs) == len(jinputs) == 2
    for x, jx in zip(inputs, jinputs):
        assert x.shape == np.shape(jx) == (1, 256, 256, 4) and x.dtype == np.asarray(jx).dtype
    model = fam.build(CHANGE_CONFIG, **SMALL)
    assert isinstance(model, SiameseUNet) and model.threshold == CHANGE_CONFIG.threshold
    full = fam.build(CHANGE_CONFIG)
    assert full.kwargs["filters"] == (32, 64, 128) and full.kwargs["factors"] == (2, 2, 2)
    assert full.kwargs["convs_per_block"] == 2 and full.aspp.ConvBNAct_0.Conv_0.out_channels == 256
    (loss_fn, key), (jloss_fn, jkey) = fam.loss(CHANGE_CONFIG), jfam.loss(JAX_CHANGE)
    assert key == jkey == "logits"
    rng = np.random.default_rng(0)
    y = (rng.uniform(size=(2, 8, 8, 1)) > 0.8).astype(np.float32)
    p = rng.normal(0, 3, y.shape).astype(np.float32)
    np.testing.assert_allclose(loss_fn(torch.from_numpy(y), torch.from_numpy(p)).numpy(),
                               np.asarray(jloss_fn(y, p)), rtol=1e-5, atol=1e-6)


def test_checkpoint_without_arch_loads_as_unet(tmp_path, rng):
    """A model.pt written before the file recorded ``arch`` holds a UNet,
    and the scene CLI still serves it."""
    model = UNet(6, n_classes=1, head="sigmoid", **SMALL).eval()
    path = save_checkpoint(str(tmp_path / "ckpt"), model, {"step": 2})
    blob = torch.load(path, weights_only=True)
    del blob["arch"]
    torch.save(blob, path)
    loaded, meta = load_checkpoint(str(tmp_path / "ckpt"))
    assert type(loaded) is UNet and meta == {"step": 2}
    scene = rng.uniform(0, 0.4, (40, 40, 6)).astype(np.float32)
    np.save(tmp_path / "scene.npy", scene)
    out = cli.main(["scene", "--input", str(tmp_path / "scene.npy"), "--ckpt",
                    str(tmp_path / "ckpt"), "--device", "cpu",
                    "--output", str(tmp_path / "p.tif"), *GEOM])
    pred, _ = read_geotiff(out)
    assert pred.shape == (40, 40, 1) and np.isfinite(pred).all()
    # a siamese checkpoint asked for as a unet (and the reverse) raises
    save_checkpoint(str(tmp_path / "siam"), SiameseUNet(4, **SMALL), {})
    with pytest.raises(ValueError, match="holds a siamese model"):
        cli.load_model(str(tmp_path / "siam"), torch.device("cpu"))
    with pytest.raises(ValueError, match="holds a unet model"):
        cli.load_model(str(tmp_path / "ckpt"), torch.device("cpu"), arch="siamese")

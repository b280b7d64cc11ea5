"""The port's training CLI (``python -m satellite_computervision_tpu_torch.train``)
and the solar example twin, end to end on the CPU at small sizes: train
on EE-schema TFRecords, keep ``best/model.pt``, serve it with the
``predict`` CLI. Without ``--device`` both default to CUDA and raise here."""

import dataclasses

import numpy as np
import pytest
import torch

from satellite_computervision_tpu_torch import predict as predict_cli
from satellite_computervision_tpu_torch import solar_end_to_end
from satellite_computervision_tpu_torch.data.tfrecord import write_tfrecord_file
from satellite_computervision_tpu_torch.geo import read_geotiff
from satellite_computervision_tpu_torch.train import __main__ as train_cli
from satellite_computervision_tpu_torch.train import zoo
from satellite_computervision_tpu_torch.train.config import SOLAR_CONFIG

K = 32


def _write_chips(path, n=8, seed=0):
    rng = np.random.default_rng(seed)
    examples = []
    for _ in range(n):
        ex = {b: rng.uniform(0, 0.3, K * K).astype(np.float32) for b in SOLAR_CONFIG.bands}
        label = np.zeros((K, K), np.float32)
        label[8:20, 10:24] = 1.0
        ex["landcover"] = label.reshape(-1)
        examples.append(ex)
    write_tfrecord_file(str(path), examples)


@pytest.fixture
def small_solar(monkeypatch):
    """The solar preset cut for the CPU (chips, serving geometry, width),
    per-channel rescaling so training goes through fused_preprocess."""
    small = dataclasses.replace(SOLAR_CONFIG, kernel_size=K, kernel_buffer=16, batch_size=4,
                                serve_kernel=K, serve_buffer=16, serve_batch=4, axes=(0, 1))
    monkeypatch.setitem(train_cli.CONFIGS, "solar", small)
    monkeypatch.setitem(predict_cli.CONFIGS, "solar", small)
    fam = zoo.FAMILIES["unet"]
    monkeypatch.setitem(zoo.FAMILIES, "unet", dataclasses.replace(
        fam, build=lambda cfg, **kw: fam.build(cfg, filters=(4, 8), factors=(2, 2), **kw)))
    return small


def test_train_then_predict_cli(tmp_path, small_solar):
    chips = tmp_path / "train.tfrecord.gz"
    _write_chips(chips)
    ckpt = str(tmp_path / "run")
    args = ["--config", "solar", "--train", str(chips), "--eval", str(chips), "--ckpt", ckpt,
            "--epochs", "1", "--steps-per-epoch", "2", "--batch-size", "4", "--device", "cpu"]
    trainer = train_cli.main(args)
    assert trainer.state.step == 2
    assert (tmp_path / "run" / "best" / "model.pt").exists()
    assert set(trainer.history[0]) >= {"epoch", "train", "val"}
    assert trainer.state.model.space_to_depth  # the solar preset's stem

    resumed = train_cli.main(args + ["--resume"])
    assert resumed.state.step == 4  # restored at 2, then 2 more steps
    assert resumed.best >= trainer.history[0]["val"]["mean_iou"]

    scene = np.random.default_rng(1).uniform(0, 0.3, (80, 72, 6)).astype(np.float32)
    np.save(tmp_path / "scene.npy", scene)
    out_tif = str(tmp_path / "pred.tif")
    predict_cli.main(["scene", "--input", str(tmp_path / "scene.npy"), "--ckpt", ckpt,
                      "--config", "solar", "--fold-bn", "--device", "cpu", "--output", out_tif,
                      "--crs", "EPSG:32617", "--transform", "10", "0", "0", "0", "-10", "0"])
    pred, meta = read_geotiff(out_tif)
    assert pred.shape == (80, 72, 1) and np.isfinite(pred).all()
    assert "32617" in meta["crs"]


@pytest.mark.parametrize("name,classes", [("solar", 1), ("parking", 1), ("solar", 3)])
def test_zoo_unet_family_matches_jax(name, classes):
    """The unet family's build, example inputs and (loss, pred_key) for a
    preset, against the JAX zoo's; losses at rtol 1e-5 / atol 1e-6."""
    from satellite_computervision_tpu.train import zoo as jzoo
    from satellite_computervision_tpu.train.config import CONFIGS as JAX_CONFIGS

    cfg = dataclasses.replace(train_cli.CONFIGS[name], num_classes=classes)
    jcfg = dataclasses.replace(JAX_CONFIGS[name], num_classes=classes)
    fam, jfam = zoo.get_family(cfg.family), jzoo.get_family(jcfg.family)
    ((x,), (jx,)) = fam.example_inputs(cfg), jfam.example_inputs(jcfg)
    assert x.shape == np.shape(jx) and x.dtype == np.asarray(jx).dtype
    model = fam.build(cfg, filters=(4, 8), factors=(2, 2))
    assert model.space_to_depth == cfg.space_to_depth and model.threshold == cfg.threshold
    assert model.head_kind == ("sigmoid" if classes == 1 else "softmax")
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert out["logits"].shape == x.shape[:3] + (classes,)

    (loss_fn, key), (jloss_fn, jkey) = fam.loss(cfg), jfam.loss(jcfg)
    assert key == jkey
    rng = np.random.default_rng(0)
    y = np.eye(max(classes, 2), dtype=np.float32)[rng.integers(0, classes + (classes == 1),
                                                               (2, 8, 8))][..., :classes]
    p = rng.uniform(0.05, 0.95, y.shape).astype(np.float32)
    np.testing.assert_allclose(loss_fn(torch.from_numpy(y), torch.from_numpy(p)).numpy(),
                               np.asarray(jloss_fn(y, p)), rtol=1e-5, atol=1e-6)
    with pytest.raises(KeyError):
        zoo.get_family("acnn")  # not ported yet


def test_example_twin_runs_on_cpu(tmp_path):
    final = solar_end_to_end.main(["--steps", "2", "--device", "cpu",
                                   "--outdir", str(tmp_path)])
    assert set(final) == {"accuracy", "mean_iou", "f1"}
    assert (tmp_path / "solar_pred.tif").exists()


def test_without_device_both_raise_where_cuda_is_absent(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    chips = tmp_path / "train.tfrecord.gz"
    _write_chips(chips, n=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--train", str(chips), "--ckpt", str(tmp_path / "run")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        solar_end_to_end.main(["--steps", "1", "--outdir", str(tmp_path / "demo")])
    assert not (tmp_path / "run").exists() and not (tmp_path / "demo").exists()

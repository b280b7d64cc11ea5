"""The port's geometry tuner (inference/tune.py) and the serving-geometry
precedence of its ``predict`` CLI against the JAX package's
``inference/tune.py`` and ``scripts/predict.py``, on the CPU at small
sizes: candidate lists equal, tuned engines working (their output equal
to an engine built at the winning geometry, exactly), tables round-trip,
and the precedence flags > a table of this device > the preset, where a
table of another device and a JAX ``tune.json`` are ignored (mirrors
tests/test_tune.py and tests/test_cli.py)."""

import argparse
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from satellite_computervision_tpu.inference import tune as jtune
from satellite_computervision_tpu.train.config import CONFIGS as JAX_CONFIGS
from satellite_computervision_tpu_torch import predict as cli
from satellite_computervision_tpu_torch.geo import read_geotiff
from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
from satellite_computervision_tpu_torch.inference.tune import (
    GeometryTiming,
    candidate_geometries,
    load_tune_table,
    save_tune_table,
    tune_engine_geometry,
)
from satellite_computervision_tpu_torch.models import UNet
from satellite_computervision_tpu_torch.train.checkpoint import save_checkpoint
from satellite_computervision_tpu_torch.train.config import CONFIGS
from test_torch_deeplab import two_torch_threads  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _mean_model(chips):
    return chips.mean(dim=-1, keepdim=True)


@pytest.mark.parametrize("hw,multiple", [
    ((1920, 1920), 32), ((4096, 4096), 32), ((10980, 2560), 64), ((700, 300), 64),
    ((96, 96), 32), ((100, 100), 32), ((50, 40), 32), ((512, 2000), 64),
])
def test_candidate_geometries_match_jax(hw, multiple):
    got = candidate_geometries(hw, chip_multiple=multiple)
    assert got == jtune.candidate_geometries(hw, chip_multiple=multiple)
    for kernel, buffer in got:
        assert (kernel + buffer) % multiple == 0 and buffer <= kernel


def test_geometry_timing_labels_and_device():
    assert GeometryTiming(512, 128, "chips", 1.0).label() == "k512+b128"
    assert GeometryTiming(1920, 0, "whole", 1.0, "cpu").label() == "whole-scene"
    assert GeometryTiming(512, 128, "chips", 1.0).device is None


def test_tuner_returns_ranked_rows_and_working_engine(rng):
    scene = rng.normal(size=(192, 192, 3)).astype(np.float32)
    cands = [(64, 32), (96, 32), (64, 64)]
    engine, rows = tune_engine_geometry(_mean_model, scene.shape, np.float32, candidates=cands,
                                        chip_multiple=32, batch_size=4, reps=1, scene=scene,
                                        device="cpu")
    # one row per candidate + whole mode (192 % 32 == 0), as the JAX tuner
    _, jrows = jtune.tune_engine_geometry(lambda c: c.mean(-1, keepdims=True), scene.shape,
                                          np.float32, candidates=cands, chip_multiple=32,
                                          batch_size=4, reps=1, scene=scene)
    key = lambda r: (r.kernel, r.buffer, r.tile_mode)  # noqa: E731
    assert sorted(map(key, rows)) == sorted(map(key, jrows))
    assert [r.ms for r in rows] == sorted(r.ms for r in rows)
    assert all(r.device == "cpu" and r.ms > 0 for r in rows)
    best = rows[0]
    if best.tile_mode == "whole":
        assert engine.tile_mode == "whole"
        ref = TiledInferenceEngine(_mean_model, tile_mode="whole", device="cpu")
    else:
        assert (engine.kernel, engine.buffer) == (best.kernel, best.buffer)
        ref = TiledInferenceEngine(_mean_model, kernel=best.kernel, buffer=best.buffer,
                                   batch_size=4, blend="hann", device="cpu")
    got = engine.predict_scene(scene)
    torch.testing.assert_close(got, ref.predict_scene(scene), rtol=0, atol=0)
    # a per-pixel model: every geometry computes the channel mean
    np.testing.assert_allclose(got[..., 0].numpy(), scene.mean(-1), rtol=1e-5, atol=1e-5)


def test_tuner_skips_whole_mode_on_unaligned_scene_and_bands_tall_ones(rng):
    _, rows = tune_engine_geometry(_mean_model, (100, 100, 1), np.float32, candidates=[(32, 16)],
                                   chip_multiple=32, batch_size=2, reps=1, device="cpu")
    assert [r.tile_mode for r in rows] == ["chips"]
    # taller than max_rows: tuned on one band of 448 rows (whole mode too:
    # its bands hold one k256 + b128 chip row), and the winner streams the
    # tall scene
    scene = rng.normal(size=(900, 64, 2)).astype(np.float32)
    engine, rows = tune_engine_geometry(_mean_model, scene.shape, np.float32,
                                        candidates=[(32, 32)], chip_multiple=32, batch_size=2,
                                        reps=1, scene=scene, max_rows=448, device="cpu")
    assert sorted((r.kernel, r.tile_mode) for r in rows) == [(32, "chips"), (448, "whole")]
    assert engine.max_rows == 448
    np.testing.assert_allclose(engine.predict_scene(scene)[..., 0].numpy(), scene.mean(-1),
                               rtol=1e-5, atol=1e-5)


def test_tune_tables_round_trip(tmp_path):
    rows = [GeometryTiming(256, 128, "chips", 9.0, "cpu"),
            GeometryTiming(512, 128, "chips", 4.5, "cpu"),
            GeometryTiming(640, 0, "whole", 6.0, "cpu")]
    path = tmp_path / "ckpt" / "tune_torch.json"
    save_tune_table(str(path), rows)
    loaded = load_tune_table(str(path))
    assert [r.ms for r in loaded] == [4.5, 6.0, 9.0]
    assert loaded[0] == GeometryTiming(512, 128, "chips", 4.5, "cpu")
    # a JAX table reads back with no device
    jpath = tmp_path / "tune.json"
    jtune.save_tune_table(str(jpath), [jtune.GeometryTiming(512, 64, "chips", 3.0)])
    assert load_tune_table(str(jpath)) == [GeometryTiming(512, 64, "chips", 3.0, None)]


def _jax_cli():
    spec = importlib.util.spec_from_file_location("jax_predict_cli",
                                                  ROOT / "scripts" / "predict.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _args(**kw):
    base = dict(kernel=None, buffer=None, batch_size=None, tile_mode="chips")
    return argparse.Namespace(**{**base, **kw})


@pytest.mark.parametrize("name", ["solar", "parking", "change"])
def test_serving_geometry_precedence_matches_jax(tmp_path, name, capsys):
    """The same rows as a JAX ``tune.json`` and as the port's table of this
    device resolve alike in both CLIs, for every preset and flag mix."""
    jcli = _jax_cli()
    cfg, jcfg = CONFIGS[name], JAX_CONFIGS[name]
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    cases = [_args(), _args(kernel=384), _args(buffer=64), _args(batch_size=4),
             _args(tile_mode="whole")]
    # no table: the preset, or the flags
    for args in cases:
        assert cli.resolve_serving_geometry(cfg, args, str(pdir)) == \
            jcli.resolve_serving_geometry(jcfg, args, str(jdir))
    for winner in (GeometryTiming(640, 128, "chips", 2.0), GeometryTiming(1024, 0, "whole", 1.0)):
        rows = [winner, GeometryTiming(256, 64, "chips", 7.0)]
        jtune.save_tune_table(str(jdir / "tune.json"),
                              [jtune.GeometryTiming(r.kernel, r.buffer, r.tile_mode, r.ms)
                               for r in rows])
        save_tune_table(str(pdir / cli.TUNE_TABLE),
                        [GeometryTiming(r.kernel, r.buffer, r.tile_mode, r.ms, "cpu")
                         for r in rows])
        for args in cases:
            got = cli.resolve_serving_geometry(cfg, args, str(pdir), torch.device("cpu"))
            assert got == jcli.resolve_serving_geometry(jcfg, args, str(jdir)), args
        assert cli.resolve_serving_geometry(cfg, _args(), str(pdir))[4].startswith("tune table")


def test_tables_of_another_device_are_ignored(tmp_path, capsys):
    cfg = CONFIGS["parking"]
    rows = [GeometryTiming(640, 128, "chips", 2.0, "NVIDIA H100 80GB HBM3")]
    save_tune_table(str(tmp_path / cli.TUNE_TABLE), rows)
    assert cli.resolve_serving_geometry(cfg, _args(), str(tmp_path), "cpu") == \
        cfg.serving_geometry + ("chips", "preset")
    assert "measured on ['NVIDIA H100 80GB HBM3'], not 'cpu'" in capsys.readouterr().out
    # rows of mixed devices, or an empty table, are not used either
    save_tune_table(str(tmp_path / cli.TUNE_TABLE),
                    rows + [GeometryTiming(256, 64, "chips", 1.0, "cpu")])
    assert cli.resolve_serving_geometry(cfg, _args(), str(tmp_path), "cpu")[4] == "preset"
    (tmp_path / cli.TUNE_TABLE).write_text("[]")
    assert cli.resolve_serving_geometry(cfg, _args(), str(tmp_path), "cpu")[4] == "preset"
    # a JAX tune.json beside the checkpoint: reported, never read
    (tmp_path / cli.TUNE_TABLE).unlink()
    (tmp_path / "tune.json").write_text(json.dumps(
        [{"kernel": 640, "buffer": 128, "tile_mode": "chips", "ms": 1.0}]))
    assert cli.resolve_serving_geometry(cfg, _args(), str(tmp_path), "cpu")[4] == "preset"
    assert "the JAX package's" in capsys.readouterr().out


def test_predict_scene_tune_writes_and_reads_the_table(tmp_path, rng, capsys):
    """``predict scene --tune --device cpu`` times the candidates, serves
    the winner and writes ``tune_torch.json``; the next serve without
    geometry flags reads it and writes the same map."""
    model = UNet(6, n_classes=1, filters=(4, 8), factors=(2, 2), head="sigmoid",
                 space_to_depth=True).eval()
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, model, {})
    scene = rng.uniform(0, 0.4, (128, 96, 6)).astype(np.float32)
    np.save(tmp_path / "scene.npy", scene)
    base = ["scene", "--input", str(tmp_path / "scene.npy"), "--ckpt", ckpt, "--device", "cpu",
            "--batch-size", "4", "--nodata", "0"]
    cli.main(base + ["--tune", "--output", str(tmp_path / "tuned.tif")])
    text = capsys.readouterr().out
    assert "tuning chip geometry on cpu" in text and "table cached at" in text
    rows = load_tune_table(str(tmp_path / "ckpt" / cli.TUNE_TABLE))
    # the S2D U-Net's chip multiple is 64: the small-scene grid k64 + b64;
    # whole mode skipped (96 is not a multiple of 64)
    assert [(r.kernel, r.buffer, r.tile_mode, r.device) for r in rows] == [
        (64, 64, "chips", "cpu")]
    cli.main(base + ["--output", str(tmp_path / "again.tif")])
    text = capsys.readouterr().out
    assert "(tune table" in text and "serving geometry: k64+b64 batch 4" in text
    tuned, meta = read_geotiff(str(tmp_path / "tuned.tif"))
    again, _ = read_geotiff(str(tmp_path / "again.tif"))
    np.testing.assert_array_equal(tuned, again)
    assert tuned.shape == (128, 96, 1) and meta.get("nodata") is None
    # explicit geometry flags skip the table
    cli.main(base + ["--kernel", "32", "--buffer", "32", "--output", str(tmp_path / "f.tif")])
    text = capsys.readouterr().out
    assert "serving geometry: k32+b32" in text and "(flags)" in text

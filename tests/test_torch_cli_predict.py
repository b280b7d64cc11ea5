"""The port's ``predict`` CLI — scene mode with banding, culling, COG and
predictors, whole mode, sweep mode and patches mode — against the JAX
package's engine and ``inference/batch.py::run_batch_prediction`` on the
same (bridged) weights, in float32 on the CPU (atol 1e-5 on
probabilities; uint8 outputs within one step)."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from satellite_computervision_tpu.data.tfrecord import TFRecordWriter, build_example, read_tfrecord_file
from satellite_computervision_tpu.geo import read_geotiff, write_geotiff
from satellite_computervision_tpu.inference import TiledInferenceEngine as JaxEngine
from satellite_computervision_tpu.inference.batch import run_batch_prediction
from satellite_computervision_tpu.inference.mixer import MixerInfo, write_mixer
from satellite_computervision_tpu.models import UNet as JaxUNet
from satellite_computervision_tpu_torch import predict as cli
from satellite_computervision_tpu_torch.models import UNet, flax_to_torch
from satellite_computervision_tpu_torch.train.checkpoint import save_checkpoint
from satellite_computervision_tpu_torch.train.config import SOLAR_CONFIG

MODEL = dict(n_classes=1, filters=(4, 8), factors=(2, 2), head="sigmoid",
             space_to_depth=True)
GEOM = ["--kernel", "16", "--buffer", "8", "--batch-size", "4"]
ENGINE = dict(kernel=16, buffer=8, batch_size=4, blend="hann")
TF = (10.0, 0.0, 500000.0, 0.0, -10.0, 4500000.0)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(checkpoint dir with the port's model.pt, JAX UNet, its variables):
    one set of weights on both sides."""
    rng = np.random.default_rng(3)
    jmodel = JaxUNet(**MODEL)
    v = jax.device_get(jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, 24, 24, 6))))
    v["params"] = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=np.shape(a)) * 0.3).astype(np.float32), v["params"])
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (np.abs(rng.normal(size=np.shape(a))) + 0.3).astype(np.float32),
        v["batch_stats"])
    model = UNet(6, **MODEL).eval()
    model.load_state_dict(flax_to_torch(v["params"], v["batch_stats"], model))
    ckpt = str(tmp_path_factory.mktemp("served") / "ckpt")
    save_checkpoint(ckpt, model, {"step": 3})
    return ckpt, jmodel, v


def _jax_engine(served, **kw):
    _, jmodel, v = served
    return JaxEngine.from_model(jmodel, v, **{**ENGINE, **kw})


def _swath(rng, h=100, w=60):
    scene = rng.uniform(0.0, 1.0, size=(h, w, 6)).astype(np.float32)
    scene[:40] = 0.0
    scene[:, :10] = 0.0
    return scene


def test_scene_banded_culled_cog_predictor3(tmp_path, rng, served, capsys):
    """A tall GeoTIFF with a nodata tag: read lazily, culled by the tag's
    value, banded, written as a float COG with predictor 3."""
    scene = _swath(rng)
    src = str(tmp_path / "swath.tif")
    write_geotiff(src, scene, transform=TF, crs="EPSG:32617", nodata=0.0)
    out = str(tmp_path / "pred.tif")
    assert cli.main(["scene", "--input", src, "--ckpt", served[0], "--output", out,
                     "--fold-bn", "--device", "cpu", "--max-rows", "48", "--cog",
                     "--predictor", "3", *GEOM]) == out
    assert "streamed banded, cog" in capsys.readouterr().out
    arr, meta = read_geotiff(out)
    want = np.asarray(_jax_engine(served, max_rows=48, nodata=0.0).predict_scene(scene))
    assert arr.shape == (100, 60, 1) and arr.dtype == np.float32
    np.testing.assert_allclose(arr, want, rtol=0, atol=1e-5)
    assert meta["crs"] == "EPSG:32617" and tuple(meta["transform"]) == TF
    assert meta["nodata"] == 0.0


def test_scene_uint8_predictor2(tmp_path, rng, served, capsys):
    scene = _swath(rng, 70, 90)
    np.save(tmp_path / "scene.npy", scene)
    out = str(tmp_path / "pred_u8.tif")
    cli.main(["scene", "--input", str(tmp_path / "scene.npy"), "--ckpt", served[0],
              "--output", out, "--fold-bn", "--device", "cpu", "--nodata", "0",
              "--uint8", "--predictor", "2", "--compress", "lzw", *GEOM])
    assert "chips carry valid pixels" in capsys.readouterr().out
    arr, meta = read_geotiff(out)
    want = np.asarray(_jax_engine(
        served, nodata=0.0, output_transform=lambda p: (p * 255.0).astype(jnp.uint8)
    ).predict_scene(scene))
    assert arr.dtype == np.uint8 and arr.shape == (70, 90, 1) and meta["nodata"] == 0.0
    # a probability within float noise of a /255 step may land one lower
    assert np.abs(arr.astype(int) - want.astype(int)).max() <= 1


def test_scene_whole_mode_ignores_tune_table(tmp_path, rng, served, capsys):
    scene = rng.uniform(0.0, 1.0, size=(50, 70, 6)).astype(np.float32)
    np.save(tmp_path / "scene.npy", scene)
    ckpt = tmp_path / "ckpt"  # the served weights beside a tune table
    ckpt.mkdir()
    os.symlink(os.path.join(served[0], "best"), ckpt / "best")
    (ckpt / "tune.json").write_text("[]")
    out = str(tmp_path / "whole.tif")
    cli.main(["scene", "--input", str(tmp_path / "scene.npy"), "--ckpt", str(ckpt),
              "--output", out, "--fold-bn", "--device", "cpu", "--tile-mode", "whole",
              *GEOM])
    assert "ignoring tune table" in capsys.readouterr().out
    arr, _ = read_geotiff(out)
    # the S2D U-Net: whole-scene padding to a multiple of 64
    want = np.asarray(_jax_engine(served, tile_mode="whole", whole_multiple=64)
                      .predict_scene(scene))
    np.testing.assert_allclose(arr, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("flags", [["--predictor", "2"], ["--predictor", "3", "--uint8"]],
                         ids=["2-needs-uint8", "3-needs-float"])
def test_predictor_dtype_errors_at_parse_time(tmp_path, flags, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["scene", "--input", "x.npy", "--ckpt", str(tmp_path), "--device", "cpu",
                  *flags])
    assert e.value.code == 2 and "--predictor" in capsys.readouterr().err


@pytest.mark.parametrize("banded", [False, True], ids=["pipelined", "banded"])
def test_sweep_shards_and_bucket(tmp_path, rng, served, capsys, banded):
    """Shard 0 of 2 takes scenes 0 and 2 (round robin); --bucket pads each
    scene to a multiple of 32 and crops back (--max-rows streams each scene
    banded instead, where --bucket is a no-op)."""
    indir = tmp_path / "scenes"
    indir.mkdir()
    shapes = [(60, 50), (48, 48), (70, 40)]
    scenes = []
    for i, (h, w) in enumerate(shapes):
        scene = _swath(rng, h, w)
        scenes.append(scene)
        np.save(indir / f"s{i}.npy", scene)
    outdir = tmp_path / "out"
    extra = ["--max-rows", "40"] if banded else []
    written = cli.main(["sweep", "--input", str(indir), "--ckpt", served[0], "--outdir",
                        str(outdir), "--fold-bn", "--device", "cpu", "--nodata", "0",
                        "--shard-index", "0", "--shard-count", "2", "--bucket", "32",
                        "--prefetch", "1", *extra, *GEOM])
    text = capsys.readouterr().out
    assert "MPix/s end-to-end" in text and ("no-op" in text) == banded
    assert written == [str(outdir / "s0_pred.tif"), str(outdir / "s2_pred.tif")]
    for path, scene in zip(written, (scenes[0], scenes[2])):
        arr, meta = read_geotiff(path)
        h, w = scene.shape[:2]
        if banded:
            want = np.asarray(_jax_engine(served, nodata=0.0, max_rows=40)
                              .predict_scene(scene))
        else:
            padded = np.pad(scene, ((0, -h % 32), (0, -w % 32), (0, 0)), mode="edge")
            want = np.asarray(_jax_engine(served, nodata=0.0).predict_scene(padded))[:h, :w]
        assert arr.shape == (h, w, 1) and meta["nodata"] == 0.0
        np.testing.assert_allclose(arr, want, rtol=0, atol=1e-5)


def test_sweep_same_stem_names_and_mixed_nodata(tmp_path, rng, served):
    indir = tmp_path / "scenes"
    indir.mkdir()
    scene = _swath(rng, 40, 40)
    np.save(indir / "de.npy", scene)
    write_geotiff(str(indir / "de.tif"), scene, nodata=0.0)
    written = cli.main(["sweep", "--input", str(indir), "--ckpt", served[0], "--outdir",
                        str(tmp_path / "out"), "--device", "cpu", *GEOM])
    assert sorted(os.path.basename(p) for p in written) == ["de_npy_pred.tif",
                                                           "de_tif_pred.tif"]
    a, _ = read_geotiff(written[0])
    b, _ = read_geotiff(written[1])
    np.testing.assert_array_equal(a, b)  # the .tif's nodata tag culls both
    write_geotiff(str(indir / "fr.tif"), scene, nodata=-1.0)
    with pytest.raises(SystemExit, match="mixed GDAL_NODATA"):
        cli.main(["sweep", "--input", str(indir), "--ckpt", served[0], "--outdir",
                  str(tmp_path / "out2"), "--device", "cpu", *GEOM])


def test_patches_matches_jax_batch_prediction(tmp_path, rng, served, capsys):
    """An EE-style export (GZIP TFRecord patches of kernel + buffer, plus
    mixer.json) through `predict patches` against the JAX
    run_batch_prediction on the same weights."""
    bands = list(SOLAR_CONFIG.bands)
    k, buf = SOLAR_CONFIG.kernel_size, SOLAR_CONFIG.kernel_buffer
    side = k + buf
    export = tmp_path / "export"
    export.mkdir()
    for f in range(2):
        with TFRecordWriter(str(export / f"solar-{f:05d}.tfrecord.gz"), "GZIP") as wr:
            for _ in range(3):
                wr.write(build_example({b: rng.uniform(0, 3000, side * side).astype(np.float32)
                                        for b in bands}))
    write_mixer(str(export / "mixer.json"), MixerInfo(6, 3, (k, k), TF, "EPSG:32617"))
    written = cli.main(["patches", "--input", str(export), "--ckpt", served[0], "--outdir",
                        str(tmp_path / "preds"), "--base", "solar", "--device", "cpu",
                        "--batch-size", "4", "--fold-bn"])
    assert "mixer: 6 patches" in capsys.readouterr().out
    _, jmodel, v = served
    from satellite_computervision_tpu.models.fold import fold_unet_variables
    fmodel, fv = fold_unet_variables(jmodel, v)
    want = run_batch_prediction(str(export), lambda x: fmodel.apply(fv, x)["probs"], bands,
                                out_dir=str(tmp_path / "jax_preds"), out_base="solar",
                                kernel_shape=(k, k), kernel_buffer=(buf, buf), batch_size=4)
    assert [os.path.basename(p) for p in written] == [os.path.basename(p) for p in want]
    got_recs = read_tfrecord_file(written[0], compression=None)
    want_recs = read_tfrecord_file(want[0], compression=None)
    assert len(got_recs) == len(want_recs) == 6
    for g, w_ in zip(got_recs, want_recs):
        assert set(g) == {"b1"} and len(g["b1"]) == k * k
        np.testing.assert_allclose(np.asarray(g["b1"]), np.asarray(w_["b1"]), rtol=0,
                                   atol=1e-5)

"""chip_smoke.py's serving phases (swath, sweep, whole, patches), its
change-detection phases (change_train, change), its parking phases
(parking_train, parking), its timeseries and landcover training phases
(timeseries_train, landcover_train), its acquisition phases (acquire,
calibrate) and its convergence phase run end to end on the CPU at a tiny
size with narrow models, so the smoke run's control flow and checks are
exercised before it reaches a card. On the
CPU ``hann_stitch`` runs its plain version, whose calls are counted here
as the kernel's launches would be."""

import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from satellite_computervision_tpu_torch import evaluate, predict
from satellite_computervision_tpu_torch.inference import tiles
from satellite_computervision_tpu_torch.kernels import preprocess as pre
from satellite_computervision_tpu_torch.kernels import stitch
from satellite_computervision_tpu_torch.models import SiameseUNet, UNet
from satellite_computervision_tpu_torch.train import zoo
from satellite_computervision_tpu_torch.train.checkpoint import save_checkpoint
from satellite_computervision_tpu_torch.train.config import CONFIGS
from test_torch_deeplab import two_torch_threads  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
FLAGS = ["--device", "cpu", "--kernel", "16", "--buffer", "8", "--batch-size", "4"]
GEOMETRY = (16, 8, 4)


@pytest.fixture
def smoke(tmp_path, monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    plain = tiles.hann_stitch

    def counted(*args, **kwargs):
        stitch.hann_stitch.launches += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(tiles, "hann_stitch", counted)
    model = UNet(6, n_classes=1, filters=(4, 8), factors=(2, 2), head="sigmoid",
                 space_to_depth=True).eval()
    cs.randomize_(model, torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, model, {})
    return cs, ckpt, str(tmp_path)


def test_swath_phase_on_cpu(smoke):
    cs, ckpt, work = smoke
    fields, launches = cs.swath_phase(torch, predict, stitch, ckpt, work, (300, 80, 6), 70, 20,
                                      72, GEOMETRY, FLAGS, device="cpu")
    # 19 chip rows in bands of 4 advancing 2: 10 bands, the first all nodata
    assert fields["bands"] == 10 and launches == fields["bands_with_kept_chip"] == 9
    assert fields["kept_chips"] < fields["total_chips"] == 19 * 5
    assert all(e == 0.0 for e in fields["max_abs_err_vs_unbanded_on_valid"].values())
    assert fields["api"]["float32/banded_culled"]["chips"] < fields["api"]["float32/banded"]["chips"]


def test_sweep_whole_and_patches_phases_on_cpu(smoke):
    cs, ckpt, work = smoke
    fields, launches = cs.sweep_phase(torch, predict, stitch, ckpt, work, (64, 64, 6), 4,
                                      GEOMETRY, FLAGS, device="cpu")
    assert launches == 4 and fields["max_abs_err_vs_predict_scene"] == [0.0] * 4
    scene_path = str(pathlib.Path(work) / "scene.npy")
    np.save(scene_path, np.random.default_rng(0).uniform(0, 0.4, (64, 64, 6)).astype(np.float32))
    whole = cs.whole_phase(torch, predict, ckpt, work, scene_path, GEOMETRY[:2], FLAGS,
                           device="cpu")
    assert whole["padded_to"] == [128, 128] and 0.0 <= whole["output_min"]
    patches = cs.patches_phase(torch, predict, ckpt, work, 2, 3,
                               ["--device", "cpu", "--batch-size", "4"])
    assert patches["records"] == 6 and patches["mixer"]


def test_change_phases_on_cpu(smoke, monkeypatch):
    """change_train: the train CLI on 8 chip triples of 40² (trimmed to
    the 32² tile), 2 steps of 4; change: a 100 x 60 pair whose left 20
    columns are nodata in both, served unbanded and banded."""
    cs, _, work = smoke
    monkeypatch.setitem(CONFIGS, "change", dataclasses.replace(
        CONFIGS["change"], kernel_size=32, kernel_buffer=8, batch_size=4, serve_kernel=16))
    fam = zoo.FAMILIES["siamese"]
    monkeypatch.setitem(zoo.FAMILIES, "siamese", dataclasses.replace(
        fam, build=lambda cfg, **kw: fam.build(cfg, filters=(4, 8), factors=(2, 2), **kw)))
    fields, ckpt, step = cs.change_train_phase(torch, work, 8, 40, 4, 2, ["--device", "cpu"],
                                               device="cpu")
    step()
    assert fields["arch"] == "siamese" and fields["batch"] == [4, 32, 32, 4]
    assert len(fields["history"]) == 1 and fields["peak_mem_gib"] is None
    fields, launches, run_scene = cs.change_phase(
        torch, predict, stitch, ckpt, work, (100, 60, 4), 20, 56, GEOMETRY, FLAGS, device="cpu")
    # 7 x 4 chips, the first column culled; bands of 3 chip rows advancing 1
    assert fields["grid"] == [7, 4] and fields["kept_chips"] == 21
    assert launches == fields["expected_launches"] == {"change": 1, "change_banded": 7}
    assert fields["zero_cols"] == 12 and fields["output_shape"] == [100, 60, 1]
    assert all(e == 0.0 for e in fields["max_abs_err_banded_culled_vs_unbanded_on_valid"].values())
    run_scene()


def test_parking_phases_on_cpu(smoke, monkeypatch):
    """parking_train: the train CLI on 2 x 4 TFRecord chips of 64² (plus 4
    eval chips) warm-started from an exported backbone, 2 steps of 2;
    parking: a 96² x 3 GeoTIFF served at the preset's k64 + b32 (2 x 2
    chips), tuned (the small-scene grid and whole mode), evaluated."""
    cs, _, work = smoke
    monkeypatch.setitem(CONFIGS, "parking", dataclasses.replace(
        CONFIGS["parking"], kernel_size=64, kernel_buffer=32, batch_size=2))
    fam = zoo.FAMILIES["deeplab"]
    monkeypatch.setitem(zoo.FAMILIES, "deeplab", dataclasses.replace(
        fam, build=lambda cfg, **kw: fam.build(cfg, stage_sizes=(1, 1, 1, 1),
                                               aspp_features=16, **kw)))
    flags = ["--device", "cpu"]
    fields, ckpt, eval_file, step = cs.parking_train_phase(torch, work, 2, 4, 2, 1, 2, flags,
                                                           device="cpu")
    step()
    assert fields["arch"] == "deeplab" and fields["chips"] == [2, 64, 64, 3]
    assert fields["steps"] == 2 and len(fields["history"]) == 2
    # the stem's conv and BN (4 tensors), 4 blocks of 3 convs + 3 BNs with a projection
    assert fields["torch_weights_tensors"] == 5 + 4 * (4 * 5)
    assert fields["f32_loss_rel_err"] == 0.0
    assert fields["f64_grad_max_abs_err_over_max_grad"] == 0.0
    assert fields["peak_mem_gib"] is None
    fields, launches, run_scene = cs.parking_phase(
        torch, predict, evaluate, stitch, ckpt, work, (96, 96, 3), eval_file, 4, flags,
        device="cpu")
    assert fields["grid"] == [2, 2] and fields["nodata_tag"] is None
    assert launches["parking"] == 1 and fields["output_shape"] == [96, 96, 1]
    assert sorted((r["kernel"], r["buffer"], r["tile_mode"]) for r in fields["tune_rows"]) == [
        (32, 32, "chips"), (96, 0, "whole")]
    assert all(r["device"] == "cpu" for r in fields["tune_rows"])
    assert fields["eval_pixels"] == 4 * 64 * 64
    run_scene()


def _narrow(monkeypatch, **families):
    for name, kw in families.items():
        fam = zoo.FAMILIES[name]
        monkeypatch.setitem(zoo.FAMILIES, name, dataclasses.replace(
            fam, build=lambda cfg, fam=fam, kw=kw, **more: fam.build(cfg, **kw, **more)))


def test_timeseries_train_phase_on_cpu(smoke, monkeypatch):
    """4 series of (7, 4, 20, 20) trimmed to 16², 2 steps of 2 for the
    ConvLSTM model and the LSTM autoencoder."""
    cs, _, work = smoke
    _narrow(monkeypatch, convlstm=dict(features=4), lstm_autoencoder=dict(features=4))
    fields, counts, steps = cs.timeseries_train_phase(torch, pre, stitch, work, 4, 20, 16, 2, 2,
                                                      ["--device", "cpu"], device="cpu")
    for step in steps.values():
        step()
    assert counts == fields["launches"] == {"hann_stitch": 0, "fused_preprocess": 0}
    conv, ae = fields["convlstm"], fields["lstm_autoencoder"]
    assert conv["arch"] == "convlstm" and conv["outputs"] == [2, 16, 16, 4]
    assert ae["outputs"] == {"temporal": [2, 6, 16, 16, 4], "single": [2, 16, 16, 4]}
    for f in (conv, ae):
        assert f["f32_loss_rel_err"] == 0.0 and f["f32_grad_max_abs_err_over_max_grad"] == 0.0
        assert len(f["history"]) == 1 and f["peak_mem_gib"] is None


def test_landcover_train_phase_on_cpu(smoke, monkeypatch):
    """landcover cut to 32² chips (which the narrow hybrid's (3, 2) pools
    do not round-trip: the CLI must refuse it) and batch 2: the ACNN on
    TFRecords with 2 evals and the evaluate CLI, the hierarchical model on
    4 npy chip sets with 8² series, the hybrid at 24² through the
    library."""
    cs, _, work = smoke
    monkeypatch.setitem(CONFIGS, "landcover", dataclasses.replace(
        CONFIGS["landcover"], kernel_size=32, batch_size=2))
    _narrow(monkeypatch, acnn=dict(n_blocks=2, features=4),
            hierarchical=dict(n_blocks=2, features=4, lstm_features=4),
            hybrid=dict(filters=(4, 8), factors=(3, 2), lstm_features=4))
    fields, counts, steps = cs.landcover_train_phase(torch, evaluate, pre, stitch, work, 4, 2,
                                                     1, 2, 8, 24, ["--device", "cpu"],
                                                     device="cpu")
    for step in steps.values():
        step()
    assert counts == {"hann_stitch": 0, "fused_preprocess": 0}
    assert sorted(steps) == ["acnn", "hierarchical", "hybrid"]
    assert fields["acnn"]["eval_pixels"] == 2 * 32 * 32 and len(fields["acnn"]["history"]) == 2
    assert "32x32 does not survive the pool factors" in fields["hybrid_at_preset_side"]
    assert fields["hybrid"]["unet_side"] == 24
    assert fields["hierarchical"]["model_kwargs"]["sub_classes"] == 4
    for name in steps:
        assert fields[name]["f32_loss_rel_err"] == 0.0
        assert fields[name]["f32_grad_max_abs_err_over_max_grad"] == 0.0


def test_acquire_and_calibrate_phases_on_cpu(smoke):
    """acquire: 2 + 2 raw items of 64² (the checked crop 32²) through the
    masks and composites, then a Siamese U-Net (filters 4/8) at k16 + b8
    over the pair, one stitch; calibrate: six 48² x 6 state scenes served
    with the smoke's U-Net, one stitch each."""
    cs, ckpt, work = smoke
    model = SiameseUNet(4, filters=(4, 8), factors=(2, 2)).eval()
    cs.randomize_(model, torch.Generator().manual_seed(1))
    change_ckpt = str(pathlib.Path(work) / "change_ckpt")
    save_checkpoint(change_ckpt, model, {})
    fields, launches = cs.acquire_phase(torch, predict, stitch, pre, change_ckpt, work, 64, 2,
                                        32, GEOMETRY, device="cpu")
    assert launches == {"hann_stitch": 1, "fused_preprocess": 0}
    assert fields["pair_shape"] == [64, 64, 8] and fields["chips"] == 16
    assert 0.0 < fields["masked_share"] < 1.0 and fields["stitch_max_abs_err"] == 0.0
    assert min(fields["crop_pixels_raw_score_below_0"]) > 0
    assert min(fields["crop_pixels_nan_index"]) > 0
    for counts in (c["valid_counts"] for c in fields["composite"].values()):
        assert len(counts) == 3 and min(counts) > 0  # 0, 1 and 2 valid dates
    assert set(fields["seconds"]) == {"synthesis", "masks", "composite", "predict", "write"}
    fields, launches = cs.calibrate_phase(torch, predict, stitch, pre, ckpt, (48, 48, 6),
                                          GEOMETRY, device="cpu")
    assert launches == {"hann_stitch": 6, "fused_preprocess": 0}
    assert list(fields["report"]) == ["DE", "MD", "PA", "NY", "VA", "WV"]


def test_parallel_phase_on_cpu(smoke, monkeypatch):
    """parallel, in a one-rank gloo group: dp_train on 2 steps of 4 solar
    chips of 64² (through the fused preprocess's plain version, counted),
    remat through the train CLI on 2 parking chips of 64², retrain from the
    smoke's checkpoint, spatial on a 160 x 96 scene and a 300 x 80 swath
    banded at 96 rows (k16 + b8: bands of 5 chip rows advancing 1), and the
    sharded engine."""
    from satellite_computervision_tpu_torch.data import pipeline
    from satellite_computervision_tpu_torch.parallel import spatial

    cs, ckpt, work = smoke
    plain_pre = pipeline.fused_preprocess

    def counted_pre(*args, **kwargs):
        pre.fused_preprocess.launches += 1
        return plain_pre(*args, **kwargs)

    monkeypatch.setattr(pipeline, "fused_preprocess", counted_pre)
    plain_stitch = spatial.hann_stitch

    def counted_stitch(*args, **kwargs):
        stitch.hann_stitch.launches += 1
        return plain_stitch(*args, **kwargs)

    monkeypatch.setattr(spatial, "hann_stitch", counted_stitch)
    _narrow(monkeypatch, unet=dict(filters=(4, 8), factors=(2, 2)))
    solar = dataclasses.replace(CONFIGS["solar"], kernel_size=64, train_batch=4)
    parking = dataclasses.replace(CONFIGS["parking"], kernel_size=64, batch_size=2)
    monkeypatch.setitem(CONFIGS, "parking", parking)
    root = pathlib.Path(work)
    (root / "tf").mkdir()
    (root / "ptf").mkdir()
    files = [str(root / "tf" / f"train-{i}.tfrecord.gz") for i in range(2)]
    for i, path in enumerate(files + [str(root / "tf" / "eval-0.tfrecord.gz")]):
        cs.synthesize_chips(path, 4, list(solar.bands), solar.response, 64, i)
    for i, name in enumerate(["train-0", "train-1", "eval-0"]):
        cs.synthesize_chips(str(root / "ptf" / f"{name}.tfrecord.gz"), 2, list(parking.bands),
                            parking.response, 64, 10 + i)
    rng = np.random.default_rng(0)
    inputs = dict(train_files=files, eval_file=str(root / "tf" / "eval-0.tfrecord.gz"),
                  train_ckpt=ckpt, parking_glob=str(root / "ptf" / "train-*"),
                  parking_eval=str(root / "ptf" / "eval-0.tfrecord.gz"),
                  scene=rng.uniform(0, 0.4, (160, 96, 6)).astype(np.float32),
                  swath=rng.uniform(0, 0.4, (300, 80, 6)).astype(np.float32), max_rows=96)
    fields, counts = cs.parallel_phase(torch, pre, stitch, work, inputs, solar, parking,
                                       GEOMETRY, dp_steps=2, remat_batch=2, retrain_steps=2,
                                       extra_flags=["--device", "cpu"], device="cpu")
    assert fields["backend"] == "gloo" and fields["world_size"] == 1
    assert counts["parallel.dp_train"] == {"hann_stitch": 0, "fused_preprocess": 2}
    assert counts["parallel.remat"] == {"hann_stitch": 0, "fused_preprocess": 0}
    assert counts["parallel.retrain"] == {"hann_stitch": 0, "fused_preprocess": 1}
    # one band each for the scene and the float32 case, 19 for the swath
    assert counts["parallel.spatial"] == {"hann_stitch": 1 + 19 + 1, "fused_preprocess": 0}
    assert counts["parallel.sharded_engine"] == {"hann_stitch": 1, "fused_preprocess": 0}
    dp = fields["dp_train"]
    assert dp["f32_loss_rel_err"] <= 1e-4 and dp["f32_grad_max_abs_err_over_max_grad"] <= 1e-3
    assert fields["remat"]["dcp_restored_bit_equal"]
    assert fields["remat"]["loss_max_rel_diff"] == 0.0
    assert fields["retrain"]["moved"] == ["head.bias", "head.weight"]
    for case in fields["spatial"]["cases"].values():
        assert case["max_abs_err_vs_engine"] <= 1e-5
    assert fields["spatial"]["stitch_row_weights_max_abs_err"] == 0.0
    assert fields["sharded_engine"]["bit_equal_to_engine"]


@pytest.mark.parametrize("h5_files", [True, False], ids=["files", "in_memory"])
def test_h5_phase_on_cpu(smoke, monkeypatch, h5_files):
    """h5: a reference-layout U-Net (filters 4/8, one conv per block) out
    and back, evaluated (--ckpt, --h5 --no-fold, --h5 folded) on 4 solar
    chips of 64², served over a 64 x 48 scene at k16 + b8 by the hann
    engine (one stitch) and by predict_chips; the four other families
    narrow (the hybrid at 24²) out and back. Through .h5 files and the
    CLIs, and with the layers in memory (the route of a host without
    h5py)."""
    cs, _, work = smoke
    monkeypatch.setattr(cs, "H5_UNET", dict(filters=(4, 8), factors=(2, 2), convs_per_block=1))
    solar = dataclasses.replace(CONFIGS["solar"], kernel_size=64)
    monkeypatch.setitem(CONFIGS, "solar", solar)
    _narrow(monkeypatch, siamese=dict(filters=(4, 8), factors=(2, 2)),
            convlstm=dict(features=4), lstm_autoencoder=dict(features=4),
            hybrid=dict(filters=(4, 8), factors=(3, 2), lstm_features=4))
    root = pathlib.Path(work) / "tf"
    root.mkdir()
    cs.synthesize_chips(str(root / "eval-0.tfrecord.gz"), 4, list(solar.bands), solar.response,
                        64, 3)
    scene = np.random.default_rng(0).uniform(0, 0.4, (64, 48, 6)).astype(np.float32)
    fields, counts = cs.h5_phase(torch, predict, evaluate, stitch, pre, work,
                                 str(root / "eval-*.tfrecord.gz"), scene, GEOMETRY, "card",
                                 device="cpu", hybrid_side=24, h5_files=h5_files)
    assert counts == {"hann_stitch": 1, "fused_preprocess": 0}
    assert fields["h5py"] == ("present" if h5_files else "absent")
    unet = fields["unet"]
    assert unet["arch"] == dict(bands=6, filters=[4, 8], factors=[2, 2], convs_per_block=1,
                                n_classes=1)
    assert unet["layers"] == 2 + 1 + 2 * 6 + 1 and unet["state_bit_equal"]
    assert isinstance(unet["h5_bytes"], int) == h5_files
    ev = fields["evaluate"]
    assert ev["eval_pixels"] == 4 * 64 * 64
    assert ev["counts"]["h5_no_fold"] == ev["counts"]["ckpt"]
    assert ev["folded_pixels_moved"] == 0 <= ev["f32_pixels_near_threshold"]  # float32 here
    serve = fields["serve"]
    assert serve["hann_launches"] == 1 and serve["stitch_max_abs_err"] == 0.0
    assert serve["predict_chips_chips"] == 3 * 2  # rows 4, 20, 36; columns 4, 20
    assert serve["predict_chips_vs_chip_loop_max_abs_err"] == 0.0
    fams = fields["families"]
    assert sorted(fams) == ["convlstm", "hybrid", "lstm_autoencoder", "siamese"]
    assert fams["siamese"]["forward_bit_equal"]
    assert fams["siamese"]["forget_bias_max_abs_err"] is None
    for name in ("convlstm", "lstm_autoencoder", "hybrid"):
        assert fams[name]["forget_bias_max_abs_err"] <= 2.4e-7


def test_convergence_phase_on_cpu(smoke, monkeypatch):
    """convergence: the four twins through main(argv) at tiny sizes with
    narrow models (U-Net and Siamese 4/8, DeepLab stages 1/1/1/1): solar
    and change scene evals one stitch each, the swath (200 x 96, k32 +
    b16) one per band, every stitch held against its plain version."""
    import functools

    from satellite_computervision_tpu_torch import (
        change_convergence,
        parking_convergence,
        solar_convergence,
    )
    from satellite_computervision_tpu_torch.models import DeepLabV3Plus

    cs, _, work = smoke
    def narrow(cls):  # the twins pass their full widths explicitly
        return lambda *a, **kw: cls(*a, **{**kw, "filters": (4, 8), "factors": (2, 2)})

    monkeypatch.setattr(solar_convergence, "UNet", narrow(UNet))
    monkeypatch.setattr(change_convergence, "SiameseUNet", narrow(SiameseUNet))
    monkeypatch.setattr(change_convergence, "K", 128)
    monkeypatch.setattr(parking_convergence, "K", 192)
    monkeypatch.setattr(parking_convergence, "DeepLabV3Plus", functools.partial(
        DeepLabV3Plus, stage_sizes=(1, 1, 1, 1), aspp_features=16))
    tiny = ["--epochs", "1", "--batch-size", "2"]
    sizes = dict(
        solar=["--train-size", "4", "--eval-size", "2", "--tile", "128"] + tiny,
        change=["--train-size", "4", "--eval-size", "2"] + tiny,
        parking_export=["--model", "deeplab", "--train-size", "2", "--eval-size", "2"] + tiny,
        parking_warm=["--model", "deeplab", "--train-size", "2", "--eval-size", "2"] + tiny,
        swath=dict(height=200, width=96, kernel=32, buffer=16,
                   flags=["--filters", "4", "8", "--batch", "4"]),
    )
    fields, counts = cs.convergence_phase(torch, pre, stitch, work, device="cpu", sizes=sizes)
    # 7 chip rows in bands of 2 + 16 rows advancing 1: 7 bands
    assert counts == {"hann_stitch": 1 + 1 + 7, "fused_preprocess": 0}
    assert [fields[n]["launches"]["hann_stitch"] for n in (
        "solar", "change", "parking_export", "parking_warm", "swath")] == [1, 1, 0, 0, 7]
    assert set(fields["solar"]["scene_eval_iou"]) == {"chips", "hann", "whole"}
    assert set(fields["change"]["scene_eval_iou"]) == {"hann", "whole"}
    assert fields["stitch"]["calls"] == 9 and fields["stitch"]["max_abs_err"] == 0.0
    assert fields["swath"]["summary"]["hann_stitch_launches"] == 7  # counted as launches here
    assert fields["parking_export"]["records"][0]["warm_start"] is False

"""chip_smoke.py's serving phases (swath, sweep, whole, patches) and its
change-detection phases (change_train, change) run end to end on the CPU
at a tiny size with a narrow U-Net / Siamese U-Net, so the smoke run's
control flow and checks are exercised before it reaches a card. On the
CPU ``hann_stitch`` runs its plain version, whose calls are counted here
as the kernel's launches would be."""

import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from satellite_computervision_tpu_torch import predict
from satellite_computervision_tpu_torch.inference import tiles
from satellite_computervision_tpu_torch.kernels import stitch
from satellite_computervision_tpu_torch.models import UNet
from satellite_computervision_tpu_torch.train import zoo
from satellite_computervision_tpu_torch.train.checkpoint import save_checkpoint
from satellite_computervision_tpu_torch.train.config import CONFIGS

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

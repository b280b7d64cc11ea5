"""Whole runs of each cell, cut to a size the CPU holds: a sound run is
correct; the control and each fault the cell can have are not."""

import json
import subprocess
import sys

import pytest
import torch

from conftest import CELLS, REPO
from perfbench import harness, manifest

calibrate = manifest.load_module(REPO / "perfbench" / "calibrate.py", "perfbench_calibrate")

CPU = torch.device("cpu")
SEED = 2**31 + 101
SERVING = [c for c in CELLS if c.endswith("sweep")]
TRAINING = [c for c in CELLS if c.endswith("train")]


@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny, name, trace):
    cell = tiny(name)
    result = harness.run_cell(cell, SEED, 0.5, trace, CPU)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks" and set(result["checks"]) == set(cell.limits["numbers"])
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"]) and "breakdown" in result
    else:
        assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}


def _fails(cell, fault=None):
    driver = cell.module("drivers", cell.traffic["driver"]).Driver(cell, SEED, CPU)
    calibrate.plant(fault, driver)
    driver.setup()
    driver.window(0.3)
    driver.finish()
    return driver


@pytest.mark.parametrize("fault", ["altered", "wrong_slot"])
@pytest.mark.parametrize("name", SERVING)
def test_altered_answer_is_not_correct(tiny, name, fault, monkeypatch):
    from satellite_computervision_tpu_torch.inference import TiledInferenceEngine

    monkeypatch.setattr(TiledInferenceEngine, "_finish", TiledInferenceEngine._finish)
    cell = tiny(name)
    checks = harness.compare(_fails(cell, fault).readings(), cell.limits)
    assert not all(c["ok"] for c in checks.values()), checks


@pytest.mark.parametrize("fault", ["frozen", "half_batch"])
@pytest.mark.parametrize("name", TRAINING)
def test_training_fault_is_not_correct(tiny, name, fault, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", torch.optim.Adam.step)
    cell = tiny(name)
    checks = harness.compare(_fails(cell, fault).readings(), cell.limits)
    assert not all(c["ok"] for c in checks.values()), checks


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(tiny, name):
    """The reference in float8 in the program's place, at the models'
    full widths (spatial sizes and counts cut)."""
    cell = tiny(name, full_width=True)
    driver = _fails(cell)
    sound = harness.compare(driver.readings(), cell.limits)
    control = harness.compare(driver.readings("float8", control=True), cell.limits)
    assert all(c["ok"] for c in sound.values()), sound
    assert not all(c["ok"] for c in control.values()), control


def test_run_refuses_without_the_chips(tmp_path):
    """No CUDA device: exit 2, nothing on standard output."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0], "--seed",
                           "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2 and proc.stdout == ""


@pytest.mark.cuda
def test_cell_runs_on_the_card(cuda):
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "parking.train",
                           "--seed", str(SEED), "--seconds", "2", "--trace", "0"], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]

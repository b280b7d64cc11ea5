"""BENCHMARK.json against the contract's shape, every cell resolved to its
files, and a cell added by new files alone."""

import hashlib
import json
import re
import shutil

import pytest
import torch

from conftest import CELLS, REPO, shrink
from perfbench import harness, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def test_manifest_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and BENCH["command"][1] == "perfbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(BENCH["configs"]) <= 24
    # a full check of 24 cells fits the driver's 43200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in BENCH["workloads"]] + \
        [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["layer"] and "\n" not in m["layer"]
        assert m["source"] in ("host_clock", "device_trace", "program_span", "program_counter")
    for c in BENCH["configs"]:
        assert (REPO / c["file"]).is_file() and c["file"].startswith("perfbench/")
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, cells // 4)


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = manifest.resolve(name)
    assert (cell.root / "drivers" / f"{cell.traffic['driver']}.py").is_file()
    assert hasattr(cell.module("families", cell.config["family"]), "build")
    assert cell.limits["numbers"]
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e  # a cell that reports a metric reports what it moves
        assert callable(cell.module("layer_metrics", m["name"]).read)


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_cell_added_by_new_files_only(tmp_path):
    """A new traffic mix (a sweep of smaller scenes) and its cell: two new
    data files and a manifest entry, no edit to a file of perfbench/."""
    root = tmp_path / "perfbench"
    shutil.copytree(REPO / "perfbench", root, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(root)
    mix = json.loads((root / "traffic" / "s2_tile_sweep.json").read_text())
    mix["scene_side"] = 5490
    (root / "traffic" / "s2_half_tiles.json").write_text(json.dumps(mix))
    shutil.copy(root / "limits" / "solar.tile_sweep.json", root / "limits" / "solar.half_tiles.json")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "solar.half_tiles", "config": "solar_unet",
                               "traffic": "s2_half_tiles", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "solar.tile_sweep" in m.get("workloads", []):
            m["workloads"].append("solar.half_tiles")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = manifest.resolve("solar.half_tiles", tmp_path / "BENCHMARK.json", root)
    assert cell.traffic["scene_side"] == 5490
    result = harness.run_cell(shrink(cell), 2**31 + 9, 0.5, False, torch.device("cpu"))
    assert result["correct"] and {"serve_mpix_s", "peak_mem_gib"} <= set(result["metrics"])
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("key,value", [("loss", "focal"), ("optimizer", "sgd")])
def test_training_settings_it_does_not_drive_are_refused(key, value):
    cell = manifest.resolve("solar.train")
    cell.config["train"][key] = value
    with pytest.raises(ValueError):
        cell.module("drivers", "train").Driver(cell, 1, torch.device("cpu"))

"""Shared fixtures of the benchmark's own tests (CPU; the card's test
decides in its fixture).

    python -m pytest perfbench/tests
"""

import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


def shrink(cell, full_width: bool = False):
    """``cell`` cut to a size the CPU runs in seconds; ``full_width``
    keeps the model's widths and cuts only the spatial sizes and counts."""
    c, t = cell.config, cell.traffic
    if not full_width:
        if c["family"] == "unet":
            c["model"].update(filters=[4, 8], factors=[2, 2])
        else:
            c["model"].update(stage_sizes=[1, 1, 1, 1], aspp_features=8)
    if "serve" in c:  # a full-width U-Net halves a chip five times
        c["serve"].update(kernel=48 if full_width else 32, buffer=16, batch=4)
    c["train"].update(tile=256, batch=8) if full_width else c["train"].update(tile=32, batch=4)
    if t["driver"] == "sweep":
        t.update(scene_side=100, distinct_scenes=2, check_within=2, check_scenes=2)
        t["imagery"]["cells"] = [16, 64]
    elif t["driver"] == "train":
        t.update(pool_chips=24, warm_steps=1)
        t["imagery"]["bands"]["cells"] = [8, 32]
    return cell


@pytest.fixture
def tiny():
    from perfbench import manifest

    return lambda name, full_width=False: shrink(manifest.resolve(name), full_width)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)

"""``BENCHMARK.json`` and the files it names.

A cell of ``workloads`` resolves by name, with no table to edit:

- its configuration: the ``file`` of its entry in ``configs``;
- its traffic mix: ``traffic/<traffic>.json``, whose ``driver`` names
  ``drivers/<driver>.py``;
- the configuration's ``family`` names ``families/<family>.py``;
- its correctness limits: ``limits/<cell>.json``;
- each per-layer metric it reports: ``layer_metrics/<metric>.py``.

A metric without a ``workloads`` key belongs to every cell.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    root: Path

    def module(self, kind: str, name: str):
        """``<root>/<kind>/<name>.py`` loaded as a module."""
        return load_module(self.root / kind / f"{name}.py", f"perfbench_{kind}_{name}")


def load_module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(workload: str, manifest: Path = REPO / "BENCHMARK.json", root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``manifest``, with its files read from
    ``root`` (the configuration file from the manifest's own directory)."""
    bench = _read(manifest)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {manifest}; have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read(manifest.parent / configs[w["config"]]["file"])
    traffic = _read(root / "traffic" / f"{w['traffic']}.json")
    limits = _read(root / "limits" / f"{workload}.json")
    return Cell(
        name=workload, chips=int(w["chips"]), config=config, traffic=traffic, limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        root=root)

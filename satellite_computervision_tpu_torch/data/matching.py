"""Chip-file identity matching across variables (naip/s2/label/...).

The port's own copy of ``satellite_computervision_tpu/data/matching.py``
(pure Python; the port imports nothing of the JAX package). Reference: get_file_id / match_files / split_files
(utils/processing.py:26-114). Chip files are named
``<...>_<...>_<...>_<id3>_<id4>....npy``; the identity is a slice of the
'_'-separated stem shared across per-variable directories (or flat
directories with ``_<var>_`` infixes).
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set


def get_file_id(f: str, delim: str = "_", parts: slice = slice(3, 5)) -> tuple:
    """Unique id tuple from a filename stem (utils/processing.py:26-45)."""
    stem = Path(f).stem
    return tuple(stem.split(delim)[parts])


def match_files(
    urls: Sequence[str],
    variables: Dict[str, dict],
    delim: str = "_",
    parts: slice = slice(3, 5),
    subset: Optional[Set[tuple]] = None,
    flatdirectory: bool = False,
) -> Dict[str, dict]:
    """Align files by unique id among variables (utils/processing.py:47-89).

    ``variables`` maps variable name -> {"files": ...} dicts; entries whose
    "files" is None are skipped. Returns a deep copy with each "files"
    replaced by the sorted list of paths whose ids occur for *every*
    variable (intersected with ``subset`` when given).
    """
    out = copy.deepcopy(variables)
    if flatdirectory:
        files_dic = {
            key: [u for u in urls if f"_{key}_" in u]
            for key, spec in out.items()
            if spec.get("files") is not None
        }
    else:
        files_dic = {
            key: [u for u in urls if f"/{key}/" in u]
            for key, spec in out.items()
            if spec.get("files") is not None
        }

    ids = [
        {get_file_id(f, delim, parts) for f in files} for files in files_dic.values()
    ]
    intersection = set.intersection(*ids) if ids else set()
    if subset:
        intersection &= set(subset)

    for var, ls in files_dic.items():
        matched = sorted(f for f in ls if get_file_id(f, delim, parts) in intersection)
        out[var]["files"] = matched
    return out


def split_files(
    files: Sequence[str],
    labels: Sequence[str] = ("label", "lu", "naip", "lidar", "s2"),
    delim: str = "_",
    parts: slice = slice(3, 5),
) -> List[List[str]]:
    """Partition a flat file list by source directory, keeping only ids
    present for every source (utils/processing.py:91-114)."""
    def fid(f):
        return tuple(Path(f).stem.split(delim)[parts])

    indices = [
        {fid(f) for f in files if label in Path(f).parts} for label in labels
    ]
    intersection = set.intersection(*indices) if indices else set()
    return [
        [f for f in files if label in Path(f).parts and fid(f) in intersection]
        for label in labels
    ]

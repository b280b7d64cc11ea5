"""Measured choice of the tiled-inference chip geometry.

Port of ``satellite_computervision_tpu/inference/tune.py``. For a fully
convolutional model the chip geometry (kernel, buffer, or one whole-scene
forward) is a serving choice, and which one is fastest is a measurement
on the device that serves: ``tune_engine_geometry`` builds one engine per
candidate, times a scene through each and returns the ranked table with
the winning engine. The candidates are the JAX package's.

- Timing is best-of-``reps`` after a warm-up call, the scene already on
  the device. On CUDA each call is timed with CUDA events around it; on
  the CPU with ``time.perf_counter``. The JAX version subtracts the cost
  of its scalar read-back (its only reliable sync there); events need no
  read-back, so there is no such floor here.
- Every row names the device it was measured on (``GeometryTiming.device``:
  ``torch.cuda.get_device_name``, or ``"cpu"``). A table is used only on
  that device (``predict.resolve_serving_geometry``).
- DeepLab's image-pooling branch averages over the whole chip, so for it
  the candidates compute slightly different maps; tuning still times
  each one as served.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from satellite_computervision_tpu_torch._device import resolve_device
from satellite_computervision_tpu_torch.inference.tiles import TiledInferenceEngine


@dataclasses.dataclass
class GeometryTiming:
    """One measured candidate. ``tile_mode='whole'`` rows have kernel =
    ``max(h, w)`` of the tuned scene and buffer = 0. ``device`` names where
    it was measured (``None`` in a JAX package's table)."""

    kernel: int
    buffer: int
    tile_mode: str
    ms: float
    device: Optional[str] = None

    def label(self) -> str:
        if self.tile_mode == "whole":
            return "whole-scene"
        return f"k{self.kernel}+b{self.buffer}"


def device_name(device) -> str:
    """The name a tune table records for ``device``."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def candidate_geometries(
    scene_hw: Tuple[int, int],
    chip_multiple: int = 32,
    max_chip: int = 1024,
) -> List[Tuple[int, int]]:
    """Default (kernel, buffer) candidates for a scene: kernels 256-640
    no larger than the scene's short side, buffers 64 and 128, the chip
    side (kernel + buffer) a multiple of ``chip_multiple`` (the model's
    total downsampling) and at most ``max_chip``; a scene too small for any
    gets one conservative grid."""
    side = min(scene_hw)
    out = []
    for kernel in (256, 384, 512, 640):
        if kernel > side:
            continue
        for buffer in (64, 128):
            if buffer > kernel or (kernel + buffer) % chip_multiple:
                continue
            if kernel + buffer > max_chip:
                continue
            out.append((kernel, buffer))
    if not out:  # tiny scene: one conservative grid
        k = max(chip_multiple, (side // 2 // chip_multiple) * chip_multiple)
        out.append((k, min(k, chip_multiple)))
    return out


def _best_ms(fn: Callable, reps: int, device: torch.device) -> float:
    """Best-of-``reps`` milliseconds of ``fn()`` after one warm-up call:
    CUDA events around each call on the card, the host clock on the CPU."""
    fn()
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            fn()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms)
    return best


def tune_engine_geometry(
    predict_fn: Callable,
    scene_shape: Tuple[int, int, int],
    scene_dtype=np.float32,
    *,
    out_channels: int = 1,
    blend: str = "hann",
    batch_size: int = 16,
    candidates: Optional[Sequence[Tuple[int, int]]] = None,
    include_whole: bool = True,
    chip_multiple: int = 32,
    preprocess_fn: Optional[Callable] = None,
    output_transform: Optional[Callable] = None,
    reps: int = 3,
    scene=None,
    max_rows: Optional[int] = None,
    verbose: Optional[Callable] = None,
    device="cuda",
) -> Tuple[TiledInferenceEngine, List[GeometryTiming]]:
    """Time each candidate geometry on ``device`` and return (the winning
    engine, the rows fastest first).

    ``scene`` supplies representative pixels (zeros when omitted; the
    times do not depend on the values). A scene taller than ``max_rows`` is
    tuned on one band of ``max_rows`` rows (the banded path's unit of
    work), and every engine carries ``max_rows`` so the winner streams at
    serve time. Whole mode is tried when the scene's sides are multiples of
    ``chip_multiple``. Full grids are timed: the engines have no
    ``nodata``. ``verbose`` (e.g. ``print``) logs each row."""
    device = resolve_device(device)
    h, w, c = scene_shape
    if max_rows is not None and h > max_rows:
        h = max_rows
        scene_shape = (h, w, c)
        if scene is not None:
            # slice first: a lazy file-backed scene decodes only the band
            scene = np.asarray(scene[:h])
    if candidates is None:
        candidates = candidate_geometries((h, w), chip_multiple=chip_multiple)
    if scene is None:
        scene = np.zeros(scene_shape, scene_dtype)
    staged = torch.from_numpy(np.ascontiguousarray(scene, scene_dtype)).to(device)
    name = device_name(device)

    def build(**kwargs):
        return TiledInferenceEngine(
            predict_fn, batch_size=batch_size, out_channels=out_channels,
            preprocess_fn=preprocess_fn, output_transform=output_transform,
            whole_multiple=chip_multiple, max_rows=max_rows, device=device, **kwargs)

    runs = [((kernel, buffer, "chips"), build(kernel=kernel, buffer=buffer, blend=blend))
            for kernel, buffer in candidates]
    if include_whole and h % chip_multiple == 0 and w % chip_multiple == 0:
        runs.append(((max(h, w), 0, "whole"),
                     build(kernel=256, buffer=128, tile_mode="whole")))

    rows: List[GeometryTiming] = []
    engines = {}
    for (kernel, buffer, mode), engine in runs:
        ms = _best_ms(lambda engine=engine: engine.predict_scene(staged), reps, device)
        row = GeometryTiming(kernel, buffer, mode, round(ms, 2), name)
        rows.append(row)
        engines[kernel, buffer, mode] = engine
        if verbose:
            verbose(f"  {row.label():>14}: {row.ms:8.2f} ms")
    rows.sort(key=lambda r: r.ms)
    best = rows[0]
    return engines[best.kernel, best.buffer, best.tile_mode], rows


def save_tune_table(path, rows: Sequence[GeometryTiming]) -> None:
    """Write a measured geometry table (JSON rows, each with its device)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump([dataclasses.asdict(r) for r in rows], f, indent=1)


def load_tune_table(path) -> List[GeometryTiming]:
    """Read a :func:`save_tune_table` file (or a JAX package's table, whose
    rows have no device) back, best row first."""
    with open(path) as f:
        rows = [GeometryTiming(**d) for d in json.load(f)]
    rows.sort(key=lambda r: r.ms)
    return rows

"""Overlap-tile chip indexing, extraction and stitch-accumulation.

Port of ``satellite_computervision_tpu/ops/chips.py`` (the reference's
``generate_chip_indices``/``extract_chips``/``predict_chips``,
utils/prediction_tools.py:87-156, and the (H, W) variant,
utils/raster_tools.py:23-46).

Geometry (the reference's): a chip has side ``kernel + buffer`` and is read
with its upper-left corner at ``(y - buffer//2, x - buffer//2)``; only the
central ``kernel x kernel`` window (upper-left at ``(y, x)``) is written to
the output. Chip centres tile the scene on a stride-``kernel`` grid, so in
``mode="reference"`` the central windows are disjoint and the reference's
``+=`` accumulation equals assignment.

:func:`stitch_chips` is the per-chip reference loop (the JAX package's
``lax.scan`` of dynamic updates): indices are arbitrary corners, not a
grid, so it is plain PyTorch slicing chip by chip, on the chips' device.
Real scenes go through ``inference.TiledInferenceEngine``, whose regular
grid blends in one ``hann_stitch`` launch.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def generate_chip_indices(height: int, width: int, kernel: int = 256, buffer: int = 128,
                          mode: str = "reference") -> np.ndarray:
    """(N, 2) int32 array of (y, x) central-window upper-left corners.

    ``mode="reference"`` reproduces utils/prediction_tools.py:87-109:
    ``range(buffer//2, dim - (kernel + buffer), kernel)``, which under-covers
    the right/bottom margins (the reference drops them). ``mode="cover"``
    adds a final clamped row/column so the kernel grid covers every pixel
    that has the full halo available."""
    side = kernel + buffer
    half = buffer // 2

    if mode == "reference":
        ys = list(range(half, height - side, kernel))
        xs = list(range(half, width - side, kernel))
    elif mode == "cover":

        def axis_positions(dim):
            last = dim - half - kernel  # largest corner with a full halo
            if last < half:
                return []
            pos = sorted({min(p, last) for p in range(half, last + 1, kernel)})
            if pos[-1] != last:
                pos.append(last)
            return pos

        ys = axis_positions(height)
        xs = axis_positions(width)
    else:
        raise ValueError(f"unknown chip index mode: {mode!r}")

    if not ys or not xs:
        return np.zeros((0, 2), dtype=np.int32)
    yy, xx = np.meshgrid(np.asarray(ys, np.int32), np.asarray(xs, np.int32), indexing="ij")
    return np.stack([yy.ravel(), xx.ravel()], axis=-1)


def _indices(indices) -> np.ndarray:
    return np.asarray(indices, np.int64).reshape(-1, 2)


def _window(y0: int, x0: int, size: int, h: int, w: int, corner) -> None:
    """Raise for a window that reaches outside the scene (JAX clamps such
    a window silently; a negative slice start here would wrap around)."""
    if y0 < 0 or x0 < 0 or y0 + size > h or x0 + size > w:
        raise ValueError(f"chip at {tuple(int(v) for v in corner)} reaches outside the "
                         f"{h}x{w} scene")


def extract_chips(scene, indices, kernel: int = 256, buffer: int = 128) -> torch.Tensor:
    """(N, side, side, C) chips from an (H, W, C) scene (a tensor keeps its
    device; an array becomes a CPU tensor). ``indices`` are central-window
    corners from :func:`generate_chip_indices`; every chip must lie inside
    the scene."""
    scene = torch.as_tensor(scene)
    side = kernel + buffer
    half = buffer // 2
    h, w = scene.shape[:2]
    chips = []
    for y, x in _indices(indices):
        y0, x0 = int(y) - half, int(x) - half
        _window(y0, x0, side, h, w, (y, x))
        chips.append(scene[y0:y0 + side, x0:x0 + side])
    if not chips:
        return scene.new_zeros((0, side, side) + tuple(scene.shape[2:]))
    return torch.stack(chips)


def center_crop(chips, kernel: int, buffer: int):
    """The central kernel x kernel window of (..., side, side, C) chips."""
    half = buffer // 2
    return chips[..., half:half + kernel, half:half + kernel, :] if chips.ndim >= 3 else chips


def _hann_window(side: int, dtype, device) -> torch.Tensor:
    """The separable Hann^0.5 chip weight of the JAX function, in float32
    math as it computes it."""
    n = torch.arange(side, dtype=torch.float32)
    win1d = torch.sqrt(torch.clamp(0.5 - 0.5 * torch.cos(2.0 * math.pi * (n + 0.5) / side),
                                   min=1e-4))
    return (win1d[:, None] * win1d[None, :]).to(device=device, dtype=dtype)


def stitch_chips(chip_preds, indices, out_shape, kernel: int = 256, buffer: int = 128,
                 blend: str = "overwrite") -> torch.Tensor:
    """Scatter chip predictions back into a full-scene tensor, one chip at
    a time in index order.

    ``chip_preds`` (N, side, side, C_out) still carries the halo;
    ``indices`` the matching (N, 2) central-window corners; ``out_shape``
    the (H, W, C_out) scene shape. Blend modes:

    - ``"overwrite"``: place the central crop (the reference's disjoint
      ``+=`` placement, utils/prediction_tools.py:147-154);
    - ``"sum"``: accumulate the crops (the literal reference op);
    - ``"hann"``: add the whole halo-bearing chip under a separable
      Hann^0.5 window and normalize by the summed window weight."""
    chip_preds = torch.as_tensor(chip_preds)
    idx = _indices(indices)
    side = kernel + buffer
    half = buffer // 2
    h, w, c = out_shape
    out = chip_preds.new_zeros((h, w, c))

    if blend in ("overwrite", "sum"):
        crops = chip_preds[:, half:half + kernel, half:half + kernel, :]
        for crop, (y, x) in zip(crops, idx):
            y, x = int(y), int(x)
            _window(y, x, kernel, h, w, (y, x))
            if blend == "sum":
                out[y:y + kernel, x:x + kernel] += crop
            else:
                out[y:y + kernel, x:x + kernel] = crop
        return out

    if blend == "hann":
        win = _hann_window(side, chip_preds.dtype, chip_preds.device)[..., None]
        wsum = chip_preds.new_zeros((h, w, 1))
        for chip, (y, x) in zip(chip_preds, idx):
            y0, x0 = int(y) - half, int(x) - half
            _window(y0, x0, side, h, w, (y, x))
            out[y0:y0 + side, x0:x0 + side] += chip * win
            wsum[y0:y0 + side, x0:x0 + side] += win
        return out / torch.clamp(wsum, min=1e-8)

    raise ValueError(f"unknown blend mode: {blend!r}")

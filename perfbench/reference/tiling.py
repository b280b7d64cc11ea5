"""Plain reference of overlap-tile serving with the hann blend.

A scene of H x W is covered by a grid of ``ceil(H/k) x ceil(W/k)`` chips
of side ``k + b`` at stride ``k``; the scene is edge-replicated by
``b/2`` on the top and left and by what the grid needs on the bottom and
right, so chip (r, c) reads padded rows ``[r*k, r*k + k + b)``. Each
chip's prediction is weighted by the outer product of the 1-D window
``w(n) = sqrt(max(0.5 - 0.5*cos(2*pi*(n + 0.5)/side), 1e-4))``, the
weighted predictions and the weights are summed where chips overlap, and
the output pixel is their ratio. A uint8 map is ``floor(255*p)``.

This is the arithmetic of the reference repository's overlap-tile
prediction with a feathered blend, written out directly: an
accumulation over chips, not the program's quadrant kernel.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F


def window_1d(side: int, device) -> torch.Tensor:
    n = torch.arange(side, dtype=torch.float64, device=device) + 0.5
    w = torch.sqrt(torch.clamp(0.5 - 0.5 * torch.cos(2.0 * math.pi * n / side), min=1e-4))
    return w.float()


def grid(h: int, w: int, kernel: int):
    """(rows, cols) of the chip grid over an h x w scene."""
    return -(-h // kernel), -(-w // kernel)


def blend_scene(scene: torch.Tensor, probs_fn: Callable, kernel: int, buffer: int,
                batch: int) -> torch.Tensor:
    """(H, W, C) scene (any dtype, on the device the work runs on) ->
    (H, W, n_out) blended float32 probabilities. ``probs_fn`` maps a
    (B, side, side, C) float32 chip batch to (B, side, side, n_out)."""
    h, w = scene.shape[:2]
    side, half = kernel + buffer, buffer // 2
    rows, cols = grid(h, w, kernel)
    padded = F.pad(scene.float().permute(2, 0, 1)[None],
                   (half, cols * kernel + half - w, half, rows * kernel + half - h),
                   mode="replicate")[0]
    win = window_1d(side, scene.device)
    win2 = (win[:, None] * win[None, :])[..., None]
    num = den = None
    corners = [(r * kernel, c * kernel) for r in range(rows) for c in range(cols)]
    for g in range(0, len(corners), batch):
        group = corners[g : g + batch]
        chips = torch.stack([padded[:, y : y + side, x : x + side] for y, x in group])
        probs = probs_fn(chips.permute(0, 2, 3, 1).contiguous()).float()
        if num is None:
            shape = (rows * kernel + buffer, cols * kernel + buffer, probs.shape[-1])
            num = torch.zeros(shape, dtype=torch.float32, device=scene.device)
            den = torch.zeros(shape[:2] + (1,), dtype=torch.float32, device=scene.device)
        for (y, x), p in zip(group, probs):
            num[y : y + side, x : x + side] += p * win2
            den[y : y + side, x : x + side] += win2
    return (num / den)[half : half + h, half : half + w]


def to_uint8(probs: torch.Tensor) -> torch.Tensor:
    return torch.floor(probs * 255.0).clamp(0, 255).to(torch.uint8)

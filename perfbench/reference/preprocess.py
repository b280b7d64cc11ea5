"""Plain reference of the training input transform and its random draws.

Per chip: the draws are, in this order from one generator, ``contra`` and
``bright`` (B, n_color) uniform in ``1 +- 0.05``, two flips (B, 2) as
``uniform < 0.5`` and a rotation (B, 1) uniform over {0, 1, 2, 3}. The
colour bands are recoloured ``(v - mean)*contra + mean*bright`` with the
chip's per-band mean, then min/max rescaled per chip and band,
``(v - min)/(max - min + 1e-8)``; then every channel of the chip (bands
and label) is flipped vertically, horizontally, and rotated by quarter
turns, in that order. Labels are clipped to at most 1.
"""

from __future__ import annotations

import torch

ADJ = 0.05


def draws(generator: torch.Generator, batch: int, n_color: int):
    contra = torch.rand((batch, n_color), generator=generator) * (2 * ADJ) + (1 - ADJ)
    bright = torch.rand((batch, n_color), generator=generator) * (2 * ADJ) + (1 - ADJ)
    flips = torch.rand((batch, 2), generator=generator) < 0.5
    rot = torch.randint(0, 4, (batch, 1), generator=generator, dtype=torch.int32)
    return contra, bright, flips, rot


def preprocess(bands: torch.Tensor, labels: torch.Tensor, drawn):
    """``bands`` (B, K, K, n_color), ``labels`` (B, K, K, 1) float32 ->
    (features, labels) as the training step receives them."""
    contra, bright, flips, rot = (t.to(bands.device) for t in drawn)
    mean = bands.mean(dim=(1, 2), keepdim=True)
    col = (bands - mean) * contra[:, None, None, :] + mean * bright[:, None, None, :]
    lo = col.amin(dim=(1, 2), keepdim=True)
    hi = col.amax(dim=(1, 2), keepdim=True)
    x = torch.cat([(col - lo) / (hi - lo + 1e-8), labels], dim=-1)
    out = []
    for chip, (fv, fh), r in zip(x, flips.tolist(), rot[:, 0].tolist()):
        if fv:
            chip = torch.flip(chip, (0,))
        if fh:
            chip = torch.flip(chip, (1,))
        out.append(torch.rot90(chip, r % 4, (0, 1)))
    x = torch.stack(out)
    return x[..., :-1], torch.clamp(x[..., -1:], max=1.0)

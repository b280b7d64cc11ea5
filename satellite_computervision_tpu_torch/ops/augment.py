"""Color and morphological augmentation with explicit draws.

Port of ``satellite_computervision_tpu/ops/augment.py`` (``aug_color``,
``draw_morph_params``, ``apply_morph``, ``aug_morph``). Every random
number is drawn from an explicit ``torch.Generator`` by a ``draw_*``
function and passed in, so the tests can inject the JAX package's draws:
torch's Philox and JAX's threefry never give the same numbers. Draws are
made on the generator's device (a CPU generator by default) and the
multipliers are moved to the image's device by the ops.

The HSV pair (``rgb_to_hsv``/``hsv_to_rgb``/``aug_color_hsv``) is not
ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def draw_color_params(generator: Optional[torch.Generator], n_ch: int,
                      contra_adj: float = 0.05, bright_adj: float = 0.05,
                      per_channel: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(contrast, brightness) multipliers, uniform in ``1 ± adj``: shape
    ``(n_ch,)`` with ``per_channel`` (the TF flavor), else scalars shared
    across channels (the NumPy flavor)."""
    shape = (n_ch,) if per_channel else ()
    contra = torch.rand(shape, generator=generator) * (2 * contra_adj) + (1.0 - contra_adj)
    bright = torch.rand(shape, generator=generator) * (2 * bright_adj) + (1.0 - bright_adj)
    return contra, bright


def aug_color(img: torch.Tensor, contra, bright, nan_aware: bool = False) -> torch.Tensor:
    """Contrast/brightness recoloring ``(x - mu)*c + mu*b`` with the
    multipliers given.

    Channel means are taken over the two spatial axes (the last two before
    the channel axis), so this works on (H, W, C) and (..., H, W, C) stacks.
    ``contra``/``bright`` broadcast against ``img``: shape (C,) or () for
    one image, (B, 1, 1, C) for per-chip draws over a batch."""
    spatial = (img.dim() - 3, img.dim() - 2)
    if nan_aware:
        ch_mean = torch.nanmean(img, dim=spatial, keepdim=True)
    else:
        ch_mean = img.mean(dim=spatial, keepdim=True)
    contra = torch.as_tensor(contra, dtype=img.dtype).to(img.device)
    bright = torch.as_tensor(bright, dtype=img.dtype).to(img.device)
    return (img - ch_mean) * contra + ch_mean * bright


def draw_morph_params(generator: Optional[torch.Generator]) -> Tuple[bool, bool, int]:
    """(flip_v, flip_h, n_rot90): two Bernoulli(0.5) flips and a rotation
    uniform over {0, 1, 2, 3}, as the reference draws them."""
    flips = torch.rand(2, generator=generator) < 0.5
    n_rot = int(torch.randint(0, 4, (), generator=generator))
    return bool(flips[0]), bool(flips[1]), n_rot


def apply_morph(img: torch.Tensor, flip_v, flip_h, n_rot) -> torch.Tensor:
    """Flip vertically, then horizontally, then rotate by ``n_rot`` × 90°
    (``torch.rot90`` over the (vertical, horizontal) axes, numpy's
    direction). With channels last the vertical axis is third from last,
    so the op works on (H, W, C) chips and (T, H, W, C) timeseries."""
    v_axis, h_axis = img.dim() - 3, img.dim() - 2
    x = torch.flip(img, (v_axis,)) if bool(flip_v) else img
    x = torch.flip(x, (h_axis,)) if bool(flip_h) else x
    return torch.rot90(x, int(n_rot) % 4, (v_axis, h_axis))


def aug_morph(generator: Optional[torch.Generator], img: torch.Tensor,
              return_params: bool = False):
    """Random flip-v / flip-h / rot90 of a channels-last stack. Apply it to
    the concatenated [features ‖ labels] stack so both transform alike."""
    params = draw_morph_params(generator)
    out = apply_morph(img, *params)
    return (out, params) if return_params else out

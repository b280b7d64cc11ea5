"""Color and morphological augmentation with explicit draws.

Port of ``satellite_computervision_tpu/ops/augment.py`` (``aug_color``,
``draw_morph_params``, ``apply_morph``, ``aug_morph``). Every random
number is drawn from an explicit ``torch.Generator`` by a ``draw_*``
function and passed in, so the tests can inject the JAX package's draws:
torch's Philox and JAX's threefry never give the same numbers. Draws are
made on the generator's device (a CPU generator by default) and the
multipliers are moved to the image's device by the ops.

The HSV pair (``rgb_to_hsv``/``hsv_to_rgb``) matches ``tf.image``, as the
JAX pair does; ``aug_color_hsv`` takes its four draws from
``draw_hsv_params``.
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


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """Channels-last RGB in [0, 1] -> HSV, matching ``tf.image.rgb_to_hsv``."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    zero, one = torch.zeros_like(maxc), torch.ones_like(maxc)
    safe = torch.where(delta == 0, one, delta)
    s = torch.where(maxc == 0, zero, delta / torch.where(maxc == 0, one, maxc))
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta == 0, zero, torch.remainder(h / 6.0, 1.0))
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """HSV -> channels-last RGB, matching ``tf.image.hsv_to_rgb``."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    sector = torch.remainder(i.to(torch.int32), 6)
    table = ((v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q))
    rgb = []
    for ch in range(3):
        out = torch.zeros_like(v)
        for k, row in enumerate(table):
            out = torch.where(sector == k, row[ch], out)
        rgb.append(out)
    return torch.stack(rgb, dim=-1)


def draw_hsv_params(generator: Optional[torch.Generator], max_hue_delta: float = 0.05,
                    saturation_range=(0.6, 1.6), max_brightness_delta: float = 0.05,
                    contrast_range=(0.7, 1.3)) -> Tuple[float, float, float, float]:
    """(hue delta, saturation scale, brightness delta, contrast scale), each
    uniform over its range, as the reference's tf.image.random_* chain
    draws them."""
    u = torch.rand(4, generator=generator, dtype=torch.float64).tolist()

    def between(x, lo, hi):
        return lo + (hi - lo) * x

    return (between(u[0], -max_hue_delta, max_hue_delta),
            between(u[1], *saturation_range),
            between(u[2], -max_brightness_delta, max_brightness_delta),
            between(u[3], *contrast_range))


def aug_color_hsv(img: torch.Tensor, hue_delta, saturation, brightness_delta,
                  contrast) -> torch.Tensor:
    """HSV-space color augmentation of channels-last RGB with the draws
    given (:func:`draw_hsv_params`): hue shift, saturation scale, brightness
    delta, contrast scale about the per-channel spatial mean — the
    reference's ``augColor`` (utils/processing.py:154-167)."""
    def scalar(x):
        return torch.as_tensor(x, dtype=img.dtype).to(img.device)

    hsv = rgb_to_hsv(img)
    hue = torch.remainder(hsv[..., 0] + scalar(hue_delta), 1.0)
    sat = torch.clamp(hsv[..., 1] * scalar(saturation), 0.0, 1.0)
    x = hsv_to_rgb(torch.stack([hue, sat, hsv[..., 2]], dim=-1))
    x = x + scalar(brightness_delta)
    mean = x.mean(dim=(-3, -2), keepdim=True)
    return (x - mean) * scalar(contrast) + mean


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

"""Everything a run feeds the program, made from ``--seed``: weights,
scenes, request images and training chips.

Each kind of input has its own stream, :func:`subseed` of the run's seed
and a tag, so adding an input never shifts another. Inputs are drawn on
the device in a few large calls; what the traffic takes from host memory
is copied there once.

Imagery is a smooth field plus noise: for each of ``cells``, a coarse
uniform grid (one value per that many pixels and band) resized
bilinearly to full size, the grids averaged, scaled to the band's range,
with Gaussian noise added. The coarsest grid makes chips and scenes
differ from each other in brightness, as regions of a state do. Labels
are a coarse field over a threshold, so positives come in blobs.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def subseed(seed: int, tag: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, tag))


# the scale of a residual branch's last BatchNorm: drawn at 1, each of a
# ResNet's blocks adds a perturbation as large as the stream it joins and
# the random network is chaotic (bfloat16 rounding alone then moves its
# map by tens of uint8 levels); trained ResNets have small branch gains,
# and the usual initialisation sets them to 0 (Goyal et al. 2017)
RESIDUAL_GAIN = 0.25


def draw_weights(specs, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Tensors for ``specs`` ((name, shape, kind, fan_in)), from one draw:
    He-normal conv weights (std sqrt(2/fan_in)), biases N(0, 0.1^2),
    BatchNorm scales 1 + N(0, 0.1^2) (times :data:`RESIDUAL_GAIN` at the
    end of a residual branch), shifts N(0, 0.1^2), running mean 0 and
    variance 1. All float32."""
    total = sum(math.prod(shape) for _, shape, _, _ in specs)
    z = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape, kind, fan_in in specs:
        n = math.prod(shape)
        t = z[off : off + n].view(shape)
        off += n
        if kind == "weight":
            t = t * math.sqrt(2.0 / fan_in)
        elif kind in ("bias", "bn_bias"):
            t = t * 0.1
        elif kind == "bn_weight":
            t = 1.0 + 0.1 * t
        elif kind == "bn_weight_residual":
            t = RESIDUAL_GAIN * (1.0 + 0.1 * t)
        elif kind == "bn_mean":
            t = torch.zeros(shape, device=device)
        elif kind == "bn_var":
            t = torch.ones(shape, device=device)
        else:
            raise ValueError(f"unknown tensor kind {kind!r}")
        out[name] = t.contiguous()
    return out


def field(gen: torch.Generator, n: int, h: int, w: int, c: int, cells, device) -> torch.Tensor:
    """(n, c, h, w) float32 smooth field in [0, 1], the mean of one
    field per cell size of ``cells``."""
    out = None
    for cell in cells:
        coarse = torch.rand((n, c, -(-h // cell) + 1, -(-w // cell) + 1), generator=gen,
                            device=device)
        x = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
        out = x if out is None else out.add_(x)
    return out.div_(len(cells))


def imagery(gen: torch.Generator, n: int, side: int, bands: int, spec: Dict, device) -> torch.Tensor:
    """(n, side, side, bands) float32 imagery in ``spec["range"]`` on the
    device: a smooth field over ``spec["cells"]`` and noise of
    ``spec["noise"]``, clipped to the range."""
    lo, hi = spec["range"]
    x = field(gen, n, side, side, bands, spec["cells"], device) * (hi - lo) + lo
    x += torch.randn(x.shape, generator=gen, device=device) * spec["noise"]
    return x.clamp_(lo, hi).permute(0, 2, 3, 1)


def host_images(gen: torch.Generator, n: int, side: int, bands: int, spec: Dict,
                device) -> np.ndarray:
    """``n`` (side, side, bands) images of ``spec["dtype"]`` in host
    memory, drawn on the device one at a time."""
    dtype = np.dtype(spec["dtype"])
    out = np.empty((n, side, side, bands), dtype)
    for i in range(n):
        x = imagery(gen, 1, side, bands, spec, device)[0].round_()
        # a range inside int16 travels as int16 and is viewed as uint16 here
        wire = torch.int16 if dtype == np.uint16 else torch.uint8
        out[i] = x.to(wire).cpu().numpy().view(dtype)
    return out


def labels(gen: torch.Generator, n: int, side: int, spec: Dict, device) -> torch.Tensor:
    """(n, side, side) float32 0/1 labels: a coarse field over
    ``spec["threshold"]``."""
    return (field(gen, n, side, side, 1, spec["cells"], device)[:, 0] > spec["threshold"]).float()


def chip_pool(gen: torch.Generator, n: int, side: int, bands: Sequence[str], response: str,
              spec: Dict, device) -> Dict[str, np.ndarray]:
    """``n`` decoded EE-schema chips in host memory: one (n, side, side)
    float32 array per band name and for ``response``."""
    x = imagery(gen, n, side, len(bands), spec["bands"], device)
    pool = {name: x[..., i].contiguous().cpu().numpy() for i, name in enumerate(bands)}
    pool[response] = labels(gen, n, side, spec["labels"], device).cpu().numpy()
    return pool

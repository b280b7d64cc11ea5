"""Sentinel-2 / Landsat cloud, water and shadow masking math on tensors.

Port of ``satellite_computervision_tpu/cloud/masking.py`` (reference:
the lazy Earth Engine images of utils/ee_tools.py:9-306). Every function
takes tensors (or arrays, which land on the CPU) and runs on the device
its inputs live on, with no host round trip, so masking and compositing
run on the card when imagery arrives as arrays (the Planetary Computer
route).

Band arrays are dicts of (..., H, W) reflectance tensors keyed by
Sentinel band names (``B1`` … ``B12``, as in the JAX module); QA/SCL are
integer tensors. Masks are ``torch.bool``.

Divisions by constants, square roots and sums over band planes go
through ``cloud._exact``, so the card's masks and scores are bit-equal to
the CPU's.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from satellite_computervision_tpu_torch.cloud import _exact

# Sentinel-2 L1C digital numbers -> TOA reflectance (utils/ee_tools.py:90-108)
TOA_BANDS = ("B1", "B2", "B3", "B4", "B5", "B6", "B7", "B8", "B8A", "B9", "B10", "B11", "B12")


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def sentinel2toa(bands: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """DN / 10000 for every reflectance band; QA60 passes through."""
    out = dict(bands)
    for name in TOA_BANDS:
        if name in out:
            out[name] = _exact.div(_f32(out[name]), 10000.0)
    return out


def rescale(x, thresholds) -> torch.Tensor:
    """Linear stretch so thresholds map to [0, 1] (utils/ee_tools.py:110-113);
    inverted thresholds flip the sense, exactly as the EE expression does."""
    lo, hi = thresholds
    return _exact.div(_f32(x) - lo, hi - lo)


def normalized_difference(a, b) -> torch.Tensor:
    return (a - b) / (a + b)


def norm_p(z) -> torch.Tensor:
    """Logistic approximation to the standard-normal CDF p-value
    (utils/ee_tools.py:9-20)."""
    z = _f32(z)
    return 1.0 - 1.0 / (1.0 + torch.exp(-1.65451 * z))


def gamma_p(stat, df) -> torch.Tensor:
    """Gamma(1, df) CDF (utils/ee_tools.py:31-37)."""
    x = _exact.div(_f32(stat), df)
    return torch.special.gammainc(torch.ones_like(x), x)


def chi_p(chi, df) -> torch.Tensor:
    """Chi-square CDF probability (utils/ee_tools.py:21-29)."""
    x = _exact.div(_f32(chi), 2.0)
    return torch.special.gammainc(torch.full_like(x, df / 2.0), x)


def normalize_minmax(img, max_img, min_img):
    """(img - min) / (max - min) (utils/ee_tools.py:39-50)."""
    return (img - min_img) / (max_img - min_img)


def standardize(img, axes=(-2, -1)) -> torch.Tensor:
    """Per-band z-scores (utils/ee_tools.py:52-70, reduceRegion -> spatial
    moments); the standard deviation has ``ddof=0``, as ``jnp.std``."""
    img = _f32(img)
    mean = img.mean(dim=axes, keepdim=True)
    sd = img.std(dim=axes, keepdim=True, correction=0)
    return (img - mean) / sd


def lda_score(bands: Dict[str, torch.Tensor], intercept: float, names: Sequence[str],
              coefficients: Sequence[float]) -> torch.Tensor:
    """Linear-discriminant band combination (utils/ee_tools.py:73-88)."""
    acc = torch.tensor(intercept, dtype=torch.float32)
    for name, coeff in zip(names, coefficients):
        acc = acc + _f32(bands[name]) * coeff
    return acc


def basic_qa_mask(qa60) -> torch.Tensor:
    """True where clear: QA60 bits 10 (cloud) and 11 (cirrus) both unset
    (utils/ee_tools.py:159-180)."""
    qa = torch.as_tensor(qa60).to(torch.int32)
    return ((qa & 1024) == 0) & ((qa & 2048) == 0)


def landsat8_sr_mask(pixel_qa) -> torch.Tensor:
    """True where clear: bits 3 (shadow) and 5 (cloud) unset
    (utils/ee_tools.py:183-195)."""
    qa = torch.as_tensor(pixel_qa).to(torch.int32)
    return ((qa & 8) == 0) & ((qa & 32) == 0)


def cloud_bands(bands: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Derived cloud-indicator bands ndmi/ndsi/cirrus/vis
    (utils/ee_tools.py:198-204)."""
    out = dict(bands)
    out["ndmi"] = normalized_difference(bands["B8"], bands["B11"])
    out["ndsi"] = normalized_difference(bands["B3"], bands["B11"])
    out["cirrus"] = bands["B1"] + bands["B10"]
    out["vis"] = bands["B4"] + bands["B3"] + bands["B2"]
    return out


def dark_channels(r, g, b) -> Dict[str, torch.Tensor]:
    """Dark-channel chromaticity angles C1/C2/C3 (utils/ee_tools.py:206-216)."""
    return {
        "C1": torch.arctan(g / torch.maximum(r, b)),
        "C2": torch.arctan(r / torch.maximum(g, b)),
        "C3": torch.arctan(b / torch.maximum(r, g)),
    }


def _saturating_uint8(x: torch.Tensor) -> torch.Tensor:
    """Float -> uint8 as XLA converts: NaN to 0, clamped to [0, 255].

    ``Tensor.to(torch.uint8)`` wraps on the CPU (-18 -> 238, 300 -> 44) and
    is undefined on CUDA; the cloud score below goes negative on every dark
    clear pixel, which a wrapped cast would call cloud."""
    return torch.nan_to_num(x, nan=0.0).clamp(0.0, 255.0).to(torch.uint8)


def raw_cloud_score(bands: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The float cloud score before its byte cast: the min over
    brightness/moisture/snow indicators of raw DN bands (TOA conversion
    applied internally). Negative on dark clear pixels; NaN where an index
    is 0/0."""
    toa = sentinel2toa(bands)
    score = torch.ones_like(toa["B2"])
    score = torch.minimum(score, rescale(toa["B2"], (0.1, 0.5)))
    score = torch.minimum(score, rescale(toa["B1"], (0.1, 0.3)))
    score = torch.minimum(score, rescale(toa["B1"] + toa["B10"], (0.15, 0.2)))
    score = torch.minimum(score, rescale(toa["B4"] + toa["B3"] + toa["B2"], (0.2, 0.8)))
    ndmi = normalized_difference(toa["B8"], toa["B11"])
    score = torch.minimum(score, rescale(ndmi, (-0.1, 0.1)))
    ndsi = normalized_difference(toa["B3"], toa["B11"])
    return torch.minimum(score, rescale(ndsi, (0.8, 0.6)))


def sentinel_cloud_score(bands: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Custom cloud likelihood in [0, 100] (utils/ee_tools.py:218-255):
    :func:`raw_cloud_score` scaled x100, floored and cast to byte with
    saturation (:func:`_saturating_uint8`)."""
    return _saturating_uint8(torch.floor(raw_cloud_score(bands) * 100.0))


def water_score(bands: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Water likelihood in [0, 1] (utils/ee_tools.py:115-157); the dark
    bands' standard deviation has ``ddof=0``, as ``jnp.std``."""
    toa = sentinel2toa(bands)
    score = torch.ones_like(toa["B2"])
    shadow_sum = toa["B8"] + toa["B11"] + toa["B12"]
    score = torch.minimum(score, torch.clamp(rescale(shadow_sum, (0.35, 0.2)), 0.0, 1.0))
    dark = [toa[b] for b in ("B3", "B4", "B8", "B11", "B12")]
    n = float(len(dark))
    mean = _exact.div(_exact.sum_planes(dark), n)
    std = _exact.sqrt(_exact.div(_exact.sum_planes([(d - mean) * (d - mean) for d in dark]), n))
    z = (toa["B2"] - std) / mean
    score = torch.minimum(score, torch.clamp(rescale(z, (0.0, 1.0)), 0.0, 1.0))
    ndsi = normalized_difference(toa["B3"], toa["B11"])
    score = torch.minimum(score, rescale(ndsi, (0.3, 0.8)))
    return torch.clamp(score, 0.0, 1.0)


def scl_mask(scl) -> torch.Tensor:
    """True where usable, from the L2A scene-classification band: not cloud
    (8, 9), cirrus (10), snow (11), dark/shadow (2, 3)
    (utils/ee_tools.py:270-306)."""
    scl = torch.as_tensor(scl).to(torch.int32)
    bad = (scl == 8) | (scl == 9) | (scl == 10) | (scl == 11) | (scl == 2) | (scl == 3)
    return ~bad


def toa_mask(bands: Dict[str, torch.Tensor], cloud_thresh: int = 15) -> torch.Tensor:
    """L1C mask: QA60 clear AND cloudScore <= thresh
    (maskTOA, utils/ee_tools.py:289-306)."""
    return basic_qa_mask(bands["QA60"]) & (sentinel_cloud_score(bands) <= cloud_thresh)


def combined_mask(bands: Dict[str, torch.Tensor], cdi=None, jrc_water=None,
                  cloud_thresh: int = 15, water_thresh: float = 0.25,
                  shadow_b11: float = 900.0) -> torch.Tensor:
    """Combined cloud/water/shadow keep-mask (``mask``,
    utils/ee_tools.py:257-268). True where a pixel survives all three:

    - clouds: cloudScore <= ``cloud_thresh``, OR-overridden by a
      Sentinel-2 CDI plane >= -0.2 when one is supplied (CDI is an EE
      server-side algorithm — here an optional precomputed input);
    - water: waterScore <= ``water_thresh``; AND, when a JRC
      surface-water plane is supplied, JRC != 2 (pass it pre-dilated —
      the reference applies a 1-px focal_max first);
    - shadow: raw-DN B11 > ``shadow_b11``.

    The reference applies basicQA before scoring; compose with
    :func:`basic_qa_mask` / :func:`apply_mask` for that full pipeline.
    """
    clouds = sentinel_cloud_score(bands) <= cloud_thresh
    if cdi is not None:
        clouds = clouds | (torch.as_tensor(cdi, device=clouds.device) >= -0.2)
    water = water_score(bands) <= water_thresh
    if jrc_water is not None:
        water = water & (torch.as_tensor(jrc_water, device=water.device) != 2)
    shadow = _f32(bands["B11"]) > shadow_b11
    return clouds & water & shadow


def apply_mask(bands: Dict[str, torch.Tensor], mask: torch.Tensor, fill=float("nan")):
    """updateMask equivalent: masked-out pixels become ``fill`` (NaN, the
    nodata convention the npy generators consume,
    utils/processing.py:553-584)."""
    return {k: torch.where(mask, _f32(v), fill) for k, v in bands.items()}

"""Per-patch normalization and rescaling (channels last).

Port of ``satellite_computervision_tpu/ops/normalize.py`` with the same
axes/moments/splits contract:

- ``axes``: axes over which moments are computed (keepdims). For an (H, W,
  C) image ``(2,)`` standardizes each pixel across channels, ``(0, 1)``
  each channel, ``(0, 1, 2)`` globally.
- ``moments``: explicit per-channel tuples overriding computed moments,
  broadcast along the channel (last) axis: ``(mean, variance)`` in the TF
  form (``std_form=False``), ``(mean, std)`` in the NumPy-twin form
  (``std_form=True``), ``(min, max)`` for rescale.
- ``splits``: sizes of contiguous channel groups handled independently;
  for :func:`normalize_image` channels beyond ``sum(splits)`` pass through,
  for :func:`rescale_image` the splits must cover every channel.
- ``nan_aware``: NaN-ignoring moments (the NumPy twins' nan* functions).
"""

from __future__ import annotations

from typing import Sequence

import torch


def _moments_arrays(moments, like: torch.Tensor):
    first = torch.tensor([m[0] for m in moments], dtype=like.dtype, device=like.device)
    second = torch.tensor([m[1] for m in moments], dtype=like.dtype, device=like.device)
    return first, second


def _split_moments(moments, splits):
    """Partition an explicit per-channel moments list by group sizes."""
    if moments is None:
        return [None] * len(splits)
    if len(moments) == sum(splits):
        out, start = [], 0
        for s in splits:
            out.append(moments[start : start + s])
            start += s
        return out
    # a single group's worth (or scalar pair) applied to every split
    return [moments] * len(splits)


def _nanvar(x, axes):
    mean = torch.nanmean(x, dim=axes, keepdim=True)
    return torch.nanmean((x - mean) ** 2, dim=axes, keepdim=True)


def _normalize_one(x, axes, epsilon, moments, nan_aware, std_form):
    if moments is not None:
        mean, second = _moments_arrays(moments, x)
        if std_form:
            return (x - mean) / (second + epsilon)
        return (x - mean) / torch.sqrt(second + epsilon)
    if nan_aware:
        mean = torch.nanmean(x, dim=axes, keepdim=True)
        var = _nanvar(x, axes)
    else:
        var, mean = torch.var_mean(x, dim=axes, keepdim=True, correction=0)
    if std_form:
        return (x - mean) / (torch.sqrt(var) + epsilon)
    return (x - mean) / torch.sqrt(var + epsilon)


def normalize_image(x: torch.Tensor, axes: Sequence[int] = (2,), epsilon: float = 1e-8,
                    moments=None, splits=None, nan_aware: bool = False,
                    std_form: bool = False) -> torch.Tensor:
    """Z-score an image by moments computed along ``axes`` (channels last)."""
    axes = tuple(axes)
    if splits:
        split_len = sum(splits)
        groups, start = [], 0
        for group_moments, size in zip(_split_moments(moments, splits), splits):
            groups.append(_normalize_one(x[..., start : start + size], axes, epsilon,
                                         group_moments, nan_aware, std_form))
            start += size
        groups.append(x[..., split_len:])
        return torch.cat(groups, dim=-1)
    return _normalize_one(x, axes, epsilon, moments, nan_aware, std_form)


def _rescale_one(x, axes, epsilon, moments, nan_aware):
    if moments is not None:
        lo, hi = _moments_arrays(moments, x)
    elif nan_aware:
        nan = torch.isnan(x)
        lo = torch.where(nan, torch.inf, x).amin(dim=axes, keepdim=True)
        hi = torch.where(nan, -torch.inf, x).amax(dim=axes, keepdim=True)
    else:
        lo = x.amin(dim=axes, keepdim=True)
        hi = x.amax(dim=axes, keepdim=True)
    return (x - lo) / ((hi - lo) + epsilon)


def rescale_image(x: torch.Tensor, axes: Sequence[int] = (2,), epsilon: float = 1e-8,
                  moments=None, splits=None, nan_aware: bool = False) -> torch.Tensor:
    """Min/max-rescale an image to [0, 1] along ``axes`` (channels last).
    With ``splits``, group sizes must cover every channel."""
    axes = tuple(axes)
    if splits:
        if sum(splits) != x.shape[-1]:
            raise ValueError(
                f"rescale splits {splits} must sum to channel count {x.shape[-1]}")
        groups, start = [], 0
        for group_moments, size in zip(_split_moments(moments, splits), splits):
            groups.append(_rescale_one(x[..., start : start + size], axes, epsilon,
                                       group_moments, nan_aware))
            start += size
        return torch.cat(groups, dim=-1)
    return _rescale_one(x, axes, epsilon, moments, nan_aware)


def normalize_timeseries(arr: torch.Tensor, maxval: float = 10000.0, minval: float = 0.0,
                         e: float = 1e-5) -> torch.Tensor:
    """Scale a timeseries into [0, 1] and zero-fill NaNs."""
    normalized = (arr - minval) / (maxval - minval + e)
    return torch.where(torch.isnan(normalized), 0.0, normalized)

"""Harmonic (sin/cos of time) encodings for the timeseries models.

Port of ``satellite_computervision_tpu/ops/harmonics.py`` (the reference's
``sin_cos``, ``make_harmonics`` and ``add_harmonic``,
utils/array_tools.py:12-24, :283-298). Angles are taken in float32, as
the JAX functions take them.
"""

from __future__ import annotations

import math

import torch


def sin_cos(t, freq: int = 6):
    """(sin, cos) of ``2*pi*t/freq``."""
    theta = 2.0 * math.pi * (torch.as_tensor(t, dtype=torch.float32) / freq)
    return torch.sin(theta), torch.cos(theta)


def make_harmonics(times, timesteps: int, dims):
    """Per-sample (sin, cos) encodings broadcast to ``(B, H, W, 2)``:
    ``times`` the 1-D start times, ``timesteps`` the annual frequency,
    ``dims`` the (H, W) shape."""
    s, c = sin_cos(times, timesteps)
    sc = torch.stack([s, c], dim=-1)  # (B, 2)
    return sc[:, None, None, :].expand((sc.shape[0],) + tuple(dims) + (2,))


def add_harmonic(timeseries: torch.Tensor) -> torch.Tensor:
    """Append per-timestep sin/cos channels (frequency T, the first image
    the start of the year) to a ``(B, T, H, W, C)`` series."""
    b, t, h, w, _ = timeseries.shape
    s, c = sin_cos(torch.arange(t, dtype=torch.float32), t)
    sc = torch.stack([s, c], dim=-1).to(timeseries.device, timeseries.dtype)  # (T, 2)
    harmonics = sc[None, :, None, None, :].expand(b, t, h, w, 2)
    return torch.cat([timeseries, harmonics], dim=-1)

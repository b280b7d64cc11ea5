"""Probability-density helpers.

Port of ``satellite_computervision_tpu/ops/stats.py`` (reference:
utils/stats.py:4-48, scipy-based; its ``lognormal_pdf`` references an
undefined ``pi`` — a latent bug fixed here). Torch functions on tensors,
run on the device of ``x``.
"""

from __future__ import annotations

import math

import torch


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def gamma_pdf(x, shape, scale) -> torch.Tensor:
    """Gamma(shape, scale) density (utils/stats.py:4-23)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    shape, scale = _f32(shape, x), _f32(scale, x)
    log_pdf = (
        (shape - 1.0) * torch.log(x)
        - x / scale
        - torch.lgamma(shape)
        - shape * torch.log(scale)
    )
    return torch.where(x > 0, torch.exp(log_pdf), torch.zeros_like(x))


def lognormal_pdf(x, mean, sd) -> torch.Tensor:
    """Log-normal density with log-space mean/sd (utils/stats.py:25-48)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    mean, sd = _f32(mean, x), _f32(sd, x)
    coeff = 1.0 / (x * sd * math.sqrt(2.0 * math.pi))
    expo = -torch.square(torch.log(x) - mean) / (2.0 * torch.square(sd))
    return torch.where(x > 0, coeff * torch.exp(expo), torch.zeros_like(x))

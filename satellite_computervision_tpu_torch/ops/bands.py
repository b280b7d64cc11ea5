"""Derived spectral bands.

Port of ``satellite_computervision_tpu/ops/bands.py`` (reference:
``calc_ndvi``, utils/processing.py:116-127), on tensors.
"""

from __future__ import annotations

import torch


def calc_ndvi(nir, red, epsilon: float = 1e-8) -> torch.Tensor:
    """NDVI = (NIR - RED) / (NIR + RED + eps) — utils/processing.py:116-127.

    Takes the raw band tensors (the reference takes a dict keyed 'B8'/'B4';
    band selection lives in the dataset layer here) and runs on their
    device."""
    nir = torch.as_tensor(nir)
    red = torch.as_tensor(red)
    return (nir - red) / (epsilon + nir + red)

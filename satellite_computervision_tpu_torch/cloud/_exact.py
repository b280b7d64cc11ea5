"""Float32 arithmetic that rounds alike on the CPU and on CUDA.

Three PyTorch habits make the card's float32 results differ from the
CPU's by an ulp: CUDA divides by a Python scalar by multiplying with its
reciprocal, CUDA's float32 ``sqrt`` is not correctly rounded, and a
reduction orders its adds by device. The masking and compositing math
goes through these helpers instead, so its masks, scores and composites on
the card are bit-equal to the CPU's (whose division and sqrt are IEEE, as
numpy's and XLA's).
"""

from __future__ import annotations

import functools
import operator
from typing import Sequence

import torch


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a true division on every device (``c`` a 0-dim tensor
    there, not a Python scalar)."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root: taken in float64, whose
    root rounds once more to the float32 one."""
    return torch.sqrt(x.double()).to(x.dtype)


def sum_planes(planes: Sequence[torch.Tensor]) -> torch.Tensor:
    """Elementwise sum of ``planes`` by explicit adds in order."""
    return functools.reduce(operator.add, planes)


def sum_along(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Sum over ``axis`` (kept) by explicit adds in index order."""
    return sum_planes(x.unbind(axis)).unsqueeze(axis)

"""Device selection for the port's entry points.

Every entry point serves on the GPU unless the caller names another
device. Without CUDA the default raises: a serving run never continues
silently on the CPU. Tests pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``; raises
    ``RuntimeError`` when a CUDA device is asked for and none exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev

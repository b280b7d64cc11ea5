"""The port's checkpoint format.

A checkpoint directory ``<dir>`` holds ``<dir>/best/model.pt`` (the
best-metric weights, as the JAX package's ``<dir>/best``): one ``torch.save``
of ``{"model_kwargs", "state_dict", "meta"}``, where ``model_kwargs`` are
the ``UNet`` constructor arguments (``UNet.kwargs``) and ``meta`` is a
JSON-able dict (step, metrics). Reading the JAX package's msgpack
checkpoints is not ported yet; tests move JAX weights across with
``models.bridge.flax_to_torch``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from satellite_computervision_tpu_torch.models.unet import UNet

CHECKPOINT_FILE = os.path.join("best", "model.pt")


def save_checkpoint(path: str, model: UNet, meta: Optional[Dict] = None) -> str:
    """Write ``model`` (weights as float32 on the CPU) to
    ``path/best/model.pt``; returns the file path."""
    os.makedirs(os.path.join(path, "best"), exist_ok=True)
    state = {k: (v.detach().float() if v.is_floating_point() else v.detach()).cpu()
             for k, v in model.state_dict().items()}
    out = os.path.join(path, CHECKPOINT_FILE)
    torch.save({"model_kwargs": dict(model.kwargs), "state_dict": state,
                "meta": dict(meta or {})}, out)
    return out


def load_checkpoint(path: str, **overrides) -> Tuple[UNet, Dict]:
    """Rebuild the ``UNet`` saved at ``path/best/model.pt`` (float32, CPU) and
    return ``(model, meta)``. ``overrides`` replace saved constructor
    arguments; a mismatching weight layout raises."""
    blob = torch.load(os.path.join(path, CHECKPOINT_FILE), map_location="cpu",
                      weights_only=True)
    model = UNet(**{**blob["model_kwargs"], **overrides})
    model.load_state_dict(blob["state_dict"])
    return model.eval(), blob["meta"]

"""Model-zoo registry: a model family's builder, example inputs and default
loss, so the training CLI builds through one place.

Port of ``satellite_computervision_tpu/train/zoo.py``: the ``unet``
family (the ``solar`` and ``parking`` configs) and the ``siamese`` family
(the ``change`` config; two inputs, before and after). The ConvLSTM,
LSTM autoencoder, hybrid, hierarchical, ACNN and DeepLab families, and the
weighted-CCE loss that hybrid and ACNN train with, are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from satellite_computervision_tpu_torch.models import losses


@dataclasses.dataclass(frozen=True)
class Family:
    """One model family: ``build(cfg, **kw)``, ``example_inputs(cfg)``
    (positional numpy inputs) and ``loss(cfg) -> (loss_fn, pred_key)``."""

    name: str
    build: Callable
    example_inputs: Callable
    loss: Callable


def _bce(cfg):
    pos = cfg.loss_kwargs.get("pos_weight", 1.0) if cfg else 1.0
    return (lambda y, p: losses.weighted_bce(y, p, pos_weight=pos, logits=True)), "logits"


def _build_unet(cfg=None, **kw):
    from satellite_computervision_tpu_torch.models import UNet

    n = cfg.num_classes if cfg else 1
    kw.setdefault("head", "sigmoid" if n == 1 else "softmax")
    kw.setdefault("threshold", cfg.threshold if cfg else 0.5)
    # the config's stem (SOLAR_CONFIG trains space-to-depth from scratch);
    # an explicit kw wins
    kw.setdefault("space_to_depth", bool(getattr(cfg, "space_to_depth", False)))
    in_channels = kw.pop("in_channels", len(cfg.bands) if cfg else 4)
    return UNet(in_channels, n_classes=n, **kw)


def _build_siamese(cfg=None, **kw):
    from satellite_computervision_tpu_torch.models import SiameseUNet

    kw.setdefault("threshold", cfg.threshold if cfg else 0.5)
    in_channels = kw.pop("in_channels", len(cfg.bands) if cfg else 4)
    return SiameseUNet(in_channels, **kw)


def _img(cfg):
    k = cfg.kernel_size if cfg else 32
    return np.zeros((1, k, k, len(cfg.bands) if cfg else 4), np.float32)


FAMILIES = {
    "unet": Family(
        "unet", _build_unet,
        lambda cfg: (_img(cfg),),
        _bce,  # every unet preset, multi-class too, as the JAX zoo trains it
    ),
    "siamese": Family(
        "siamese", _build_siamese,
        lambda cfg: (_img(cfg), _img(cfg)),  # before, after
        _bce,
    ),
}


def get_family(name: str) -> Family:
    if name not in FAMILIES:
        raise KeyError(f"unknown model family {name!r}; choose from {sorted(FAMILIES)}")
    return FAMILIES[name]

"""The DeepLab v3+ family: the program's model built from a configuration
file's ``model`` section, beside its plain reference."""

from __future__ import annotations

import torch

from perfbench.families.unet import load
from perfbench.reference import deeplab as reference  # noqa: F401


def build(model: dict, device, weights: dict) -> torch.nn.Module:
    from satellite_computervision_tpu_torch.models import DeepLabV3Plus

    with torch.device("meta"):
        net = DeepLabV3Plus(model["in_channels"], n_classes=model["n_classes"],
                            stage_sizes=model["stage_sizes"],
                            aspp_features=model["aspp_features"],
                            aspp_rates=tuple(model["aspp_rates"]), head=model["head"],
                            threshold=model["threshold"])
    return load(net, device, weights)

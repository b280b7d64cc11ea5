"""The Prithvi-EO-2.0 family: the program's ViT with a segmentation head
built from a configuration file's ``model`` section, beside its plain
reference. It serves as the U-Net does (``serving``: bfloat16,
channels-last on the card; BatchNorm is not folded)."""

from __future__ import annotations

import torch

from perfbench.families.unet import load, serving  # noqa: F401
from perfbench.reference import prithvi as reference  # noqa: F401


def build(model: dict, device, weights: dict) -> torch.nn.Module:
    """The program's ``PrithviSegmenter`` (float32) holding ``weights``."""
    from satellite_computervision_tpu_torch.models import PrithviSegmenter

    if model["bands"] * model["frames"] != model["in_channels"]:
        raise ValueError("in_channels must be bands x frames (a frame-major stack)")
    with torch.device("meta"):
        net = PrithviSegmenter(model["in_channels"], frames=model["frames"], patch=model["patch"],
                               width=model["width"], depth=model["depth"], heads=model["heads"],
                               mlp=model["mlp"], n_classes=model["n_classes"], head=model["head"],
                               threshold=model["threshold"], head_widths=model["head_widths"],
                               mean=model["mean"], std=model["std"],
                               bn_momentum=model["bn_momentum"])
    return load(net, device, weights)

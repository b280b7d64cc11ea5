"""The SatlasPretrain family: the program's multi-image Swin-v2 segmenter
built from a configuration file's ``model`` section, beside its plain
reference. It serves as the U-Net does (``serving``: bfloat16,
channels-last on the card); it has no BatchNorm to fold."""

from __future__ import annotations

import torch

from perfbench.families.unet import load, serving  # noqa: F401
from perfbench.reference import satlas as reference  # noqa: F401

KEYS = ("frames", "patch", "embed", "depths", "heads", "window", "mlp_ratio", "fpn",
        "upsample_widths", "head_width", "n_classes", "head", "threshold", "scale")


def build(model: dict, device, weights: dict) -> torch.nn.Module:
    """The program's ``SatlasSwinSegmenter`` (float32) holding ``weights``."""
    from satellite_computervision_tpu_torch.models import SatlasSwinSegmenter

    if model["bands"] * model["frames"] != model["in_channels"]:
        raise ValueError("in_channels must be bands x frames (a frame-major stack)")
    with torch.device("meta"):
        net = SatlasSwinSegmenter(model["in_channels"], **{k: model[k] for k in KEYS})
    return load(net, device, weights)

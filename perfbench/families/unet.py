"""The U-Net family: the program's model built from a configuration
file's ``model`` section, beside its plain reference."""

from __future__ import annotations

import torch

from perfbench.reference import unet as reference  # noqa: F401


def build(model: dict, device, weights: dict) -> torch.nn.Module:
    """The program's ``UNet`` (live BatchNorm, float32) holding ``weights``."""
    from satellite_computervision_tpu_torch.models import UNet

    with torch.device("meta"):
        net = UNet(model["in_channels"], n_classes=model["n_classes"], filters=model["filters"],
                   factors=model["factors"], head=model["head"], threshold=model["threshold"],
                   convs_per_block=model["convs_per_block"],
                   space_to_depth=model["space_to_depth"], bn_momentum=model["bn_momentum"])
    return load(net, device, weights)


def load(net: torch.nn.Module, device, weights: dict) -> torch.nn.Module:
    """``net`` allocated on ``device`` with ``weights`` copied in; every
    tensor of its ``state_dict`` but the BatchNorm step counts must be
    given, and nothing else."""
    net = net.to_empty(device=device)
    state = dict(weights)
    for key, value in net.state_dict().items():
        if key.endswith("num_batches_tracked"):
            state[key] = torch.zeros_like(value)
    net.load_state_dict(state, strict=True)
    return net


def _dtype(serve: dict):
    """``None`` (the CLI's default: bfloat16, channels-last on CUDA) or
    the float type the configuration serves in."""
    return None if serve["dtype"] == "bfloat16" else getattr(torch, serve["dtype"])


def serving(net: torch.nn.Module, serve: dict, device) -> torch.nn.Module:
    """The served model, as ``predict.py`` prepares it: BatchNorm folded
    when the configuration serves it folded, then bfloat16 channels-last."""
    from satellite_computervision_tpu_torch.models import fold_unet
    from satellite_computervision_tpu_torch.predict import to_serving

    net = net.eval()
    if serve["fold_bn"]:
        net = fold_unet(net)
    return to_serving(net, device, _dtype(serve)).eval()

"""Plain reference of the binary U-Net (the solar model).

The U-Net of the reference repository's ``utils/model_tools.py``, as the
configuration file states it: per level two 3x3 conv -> BatchNorm -> ReLU,
max-pooling by the level's factor, a centre block of twice the last
width, and per level on the way up a stride-``factor`` transposed conv,
the skip concatenated in front, BatchNorm -> ReLU over the concatenation,
then two 3x3 conv -> BatchNorm -> ReLU; a 1x1 head with a sigmoid. The
program's space-to-depth stem is no part of that model, and a
configuration that asks for it is refused.

Inputs and outputs are NHWC float32. Parameters are a dict named as the
program's ``state_dict`` names them; :func:`specs` lists them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.layers import Ops, batch_norm, bn_spec, conv_spec, conv_transpose_spec


def specs(model: dict):
    """``(name, shape, kind, fan_in)`` of every tensor of the model."""
    if model["space_to_depth"]:
        raise ValueError("the reference U-Net has the published plain stem only")
    c_in = model["in_channels"]
    n_convs = model["convs_per_block"]
    out = []

    def cbr(prefix, cin, cout):
        out.extend(conv_spec(f"{prefix}.Conv_0", cout, cin, 3))
        out.extend(bn_spec(f"{prefix}.BatchNorm_0", cout))

    ch = c_in
    for i, feat in enumerate(model["filters"]):
        for j in range(n_convs):
            cbr(f"EncoderBlock_{i}.ConvBlock_0.ConvBNAct_{j}", ch if j == 0 else feat, feat)
        ch = feat
    centre = model["filters"][-1] * 2
    for j in range(n_convs):
        cbr(f"ConvBlock_0.ConvBNAct_{j}", ch if j == 0 else centre, centre)
    ch = centre
    for i, (feat, factor) in enumerate(zip(reversed(model["filters"]),
                                           reversed(model["factors"]))):
        d = f"DecoderBlock_{i}"
        out.extend(conv_transpose_spec(f"{d}.ConvTranspose_0", ch, feat, factor))
        out.extend(bn_spec(f"{d}.BatchNorm_0", 2 * feat))
        out.extend(conv_spec(f"{d}.Conv_0", feat, 2 * feat, 3))
        out.extend(bn_spec(f"{d}.BatchNorm_1", feat))
        out.extend(conv_spec(f"{d}.Conv_1", feat, feat, 3))
        out.extend(bn_spec(f"{d}.BatchNorm_2", feat))
        ch = feat
    out.extend(conv_spec("head", model["n_classes"], ch, 1))
    return out


def logits(p: dict, x: torch.Tensor, model: dict, ops: Ops, bn: str = "eval"):
    """(B, H, W, C) float32 -> (B, H, W, n_classes) float32 logits."""
    eps = model["bn_eps"]
    n_convs = model["convs_per_block"]

    def cbr(prefix, x, conv="Conv_0", norm="BatchNorm_0"):
        x = ops.conv(x, p[f"{prefix}.{conv}.weight"], p[f"{prefix}.{conv}.bias"], padding=1)
        return F.relu(batch_norm(x, p, f"{prefix}.{norm}", eps, bn))

    x = x.permute(0, 3, 1, 2)
    skips = []
    for i, factor in enumerate(model["factors"]):
        for j in range(n_convs):
            x = cbr(f"EncoderBlock_{i}.ConvBlock_0.ConvBNAct_{j}", x)
        skips.append(x)
        x = F.max_pool2d(x, factor, factor)
    for j in range(n_convs):
        x = cbr(f"ConvBlock_0.ConvBNAct_{j}", x)
    for i, (skip, factor) in enumerate(zip(reversed(skips), reversed(model["factors"]))):
        d = f"DecoderBlock_{i}"
        up = ops.conv_transpose(x, p[f"{d}.ConvTranspose_0.weight"],
                                p[f"{d}.ConvTranspose_0.bias"], factor)
        x = F.relu(batch_norm(torch.cat([skip, up], dim=1), p, f"{d}.BatchNorm_0", eps, bn))
        x = cbr(d, x, "Conv_0", "BatchNorm_1")
        x = cbr(d, x, "Conv_1", "BatchNorm_2")
    x = ops.conv(x, p["head.weight"], p["head.bias"])
    return x.permute(0, 2, 3, 1)

"""BatchNorm folding for inference serving.

Port of ``satellite_computervision_tpu/models/fold.py``. At inference a
BatchNorm is a constant per-channel affine
``y = (x - mean) / sqrt(var + eps) * gamma + beta``; when it directly
follows a conv, that affine folds into the conv's weight and bias, so the
served model carries no BN ops.

- every ConvBNAct's BN folds into its conv (encoders, center, decoder
  tail convs);
- each DecoderBlock's post-concat BN becomes ``affine_0_scale/bias``;
- the space-to-depth stem's ``stem_upsample_bn`` folds into
  ``stem_upsample``.

Like the JAX version, the fold runs in float64 and casts to float32. Fold
a float32 model, then cast the result to the serving dtype.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from satellite_computervision_tpu_torch.models.blocks import ConvBNAct, DecoderBlock
from satellite_computervision_tpu_torch.models.unet import UNet


def _affine(bn: nn.BatchNorm2d):
    """BN -> (a, c) in float64 with y = a*x + c per channel."""
    g = bn.weight.detach().double().cpu()
    b = bn.bias.detach().double().cpu()
    m = bn.running_mean.double().cpu()
    v = bn.running_var.double().cpu()
    a = g / torch.sqrt(v + bn.eps)
    return a, b - m * a


def _fold_conv(conv: nn.Module, bn: nn.BatchNorm2d, out_dim: int) -> Dict[str, torch.Tensor]:
    """Fold a following BN into a conv (output channels on dim 0) or a
    transposed conv (output channels on dim 1)."""
    a, c = _affine(bn)
    shape = [1, 1, 1, 1]
    shape[out_dim] = -1
    w = conv.weight.detach().double().cpu() * a.reshape(shape)
    bias = conv.bias.detach().double().cpu() * a + c
    return {"weight": w.float(), "bias": bias.float()}


def fold_unet(model: UNet) -> UNet:
    """``UNet`` with live BN -> the same ``UNet`` built with
    ``fold_bn=True``, on the source's device and dtype. The folded model
    computes the eval-mode forward with every BN op removed."""
    if model.fold_bn:
        raise ValueError("model is already folded")
    ref = next(model.parameters())
    state: Dict[str, torch.Tensor] = {}

    def put(prefix, tensors):
        for k, v in tensors.items():
            state[f"{prefix}.{k}"] = v

    for name, mod in model.named_modules():
        if isinstance(mod, ConvBNAct):
            put(f"{name}.Conv_0", _fold_conv(mod.Conv_0, mod.BatchNorm_0, 0))
        elif isinstance(mod, DecoderBlock):
            put(f"{name}.ConvTranspose_0", {
                "weight": mod.ConvTranspose_0.weight.detach().float().cpu(),
                "bias": mod.ConvTranspose_0.bias.detach().float().cpu(),
            })
            a, c = _affine(mod.BatchNorm_0)
            state[f"{name}.affine_0_scale"] = a.float()
            state[f"{name}.affine_0_bias"] = c.float()
            for i in range(2):
                put(f"{name}.Conv_{i}", _fold_conv(
                    getattr(mod, f"Conv_{i}"), getattr(mod, f"BatchNorm_{i + 1}"), 0))
    if model.space_to_depth:
        put("stem_upsample", _fold_conv(model.stem_upsample, model.stem_upsample_bn, 1))
    put("head", {k: v.detach().float().cpu() for k, v in model.head.state_dict().items()})

    folded = UNet(**{**model.kwargs, "fold_bn": True})
    folded.load_state_dict(state)
    return folded.to(device=ref.device, dtype=ref.dtype).eval()

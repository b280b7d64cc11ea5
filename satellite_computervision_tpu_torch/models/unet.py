"""Parametric U-Net (multiclass / binary / autoencoder heads).

Port of ``satellite_computervision_tpu/models/unet.py``. ``head`` picks the
output dict:

- ``"softmax"``  -> {"probs", "classes"(argmax), "logits"}
- ``"sigmoid"``  -> {"probs", "classes"(> threshold), "logits"}
- ``"linear"``   -> {"continuous"}

The public forward keeps the JAX layout: NHWC in, NHWC out. Inside, the
trunk runs NCHW; an NHWC input permuted to NCHW has channels-last strides,
which is what cuDNN prefers on the card. The input is cast to the
parameters' dtype (bf16 when serving; training in bf16 runs float32
parameters under ``torch.autocast``), and the logits are cast to float32
before the head, as the JAX model does. Folded and serving on the card,
every per-channel op after a conv runs in the hand-written epilogue
kernels (``models/blocks.py``), the space-to-depth stem's upsample and
ReLU too.

``remat=True`` runs each encoder, centre and decoder block through
``torch.utils.checkpoint`` (flax ``nn.remat`` per block in the JAX model):
a training forward keeps only the blocks' inputs and recomputes the rest
during backward. The module tree, so the ``state_dict``, is the same with
and without it. The recompute runs train-mode BatchNorm a second time; it
normalizes by the batch as the forward did, and the running statistics
are put back as the forward left them (:func:`_remat`).

A new ``UNet`` starts from flax's default initialization
(:func:`flax_init_`): truncated LeCun-normal kernels, zero biases (the
head's bias ``output_bias`` when given), BatchNorm scale 1 and bias 0.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from satellite_computervision_tpu_torch.models.blocks import (
    BN_MOMENTUM,
    ConvBlock,
    DecoderBlock,
    EncoderBlock,
    _bn,
    conv_bias_relu_,
    epilogue_route,
)

# flax's truncated_normal initializer draws a standard normal truncated at
# +-2 and divides the target std by this (the truncated normal's std)
_TRUNC_STD = 0.87962566103423978


def flax_init_(model: nn.Module, generator: Optional[torch.Generator] = None,
               output_bias: Optional[float] = None) -> nn.Module:
    """Reset ``model``'s weights in place to flax's defaults: conv and
    transposed-conv kernels ``lecun_normal`` (truncated normal, std
    ``sqrt(1/fan_in)``, fan_in = in_channels * kh * kw, as flax counts it
    for both kinds), zero biases, BatchNorm scale 1 / bias 0 and fresh
    running statistics. ``output_bias`` sets the ``head`` conv's bias.
    Draws come from ``generator`` (torch's default generator if None)."""
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                w = mod.weight
                in_ch = w.shape[1] if isinstance(mod, nn.Conv2d) else w.shape[0]
                std = (1.0 / (in_ch * w.shape[2] * w.shape[3])) ** 0.5 / _TRUNC_STD
                w.copy_(torch.nn.init.trunc_normal_(
                    torch.empty(w.shape), std=std, a=-2 * std, b=2 * std,
                    generator=generator))
                if mod.bias is not None:
                    bias = output_bias if name == "head" and output_bias is not None else 0.0
                    mod.bias.fill_(bias)
            elif isinstance(mod, nn.BatchNorm2d):
                mod.reset_parameters()
    return model


def _remat(block: nn.Module, *args):
    """``block(*args)`` under activation checkpointing (non-reentrant;
    dropout masks replayed from the saved RNG state). The first call of
    ``run`` is the forward; any later one is the recompute in backward,
    after which the BatchNorm buffers (running mean and variance,
    ``num_batches_tracked``) are restored: one step moves them once, as a
    plain step and flax's functional ``batch_stats`` do."""
    buffers = [b for m in block.modules() if isinstance(m, nn.BatchNorm2d)
               for b in (m.running_mean, m.running_var, m.num_batches_tracked)]
    calls = []

    def run(*a):
        if not calls:
            calls.append(True)
            return block(*a)
        saved = [b.clone() for b in buffers]
        try:
            return block(*a)
        finally:
            with torch.no_grad():
                for b, s in zip(buffers, saved):
                    b.copy_(s)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=True)


def _plain(block: nn.Module, *args):
    return block(*args)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C) with the JAX package's channel
    order ``(dy*2 + dx)*C + c`` (``F.pixel_unshuffle`` orders channels
    ``c*4 + dy*2 + dx``, which is a different layout)."""
    b, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError("space_to_depth needs even spatial dims")
    return (
        x.reshape(b, h // 2, 2, w // 2, 2, c)
        .permute(0, 1, 3, 2, 4, 5)
        .reshape(b, h // 2, w // 2, 4 * c)
    )


class UNet(nn.Module):
    def __init__(
        self,
        in_channels: int,
        n_classes: int = 1,
        filters: Sequence[int] = (32, 64, 128, 256, 512),
        factors: Sequence[int] = (2, 2, 2, 2, 2),
        head: str = "softmax",
        threshold: float = 0.5,
        convs_per_block: int = 2,
        space_to_depth: bool = False,
        fold_bn: bool = False,
        bn_momentum: float = BN_MOMENTUM,
        dropout: Optional[float] = None,
        output_bias: Optional[float] = None,
        remat: bool = False,
    ):
        super().__init__()
        if len(filters) != len(factors):
            raise ValueError("filters and factors must be the same length")
        if head not in ("softmax", "sigmoid", "linear"):
            raise ValueError(f"unknown head {head!r}")
        self.kwargs = dict(
            in_channels=in_channels, n_classes=n_classes, filters=tuple(filters),
            factors=tuple(factors), head=head, threshold=threshold,
            convs_per_block=convs_per_block, space_to_depth=space_to_depth,
            fold_bn=fold_bn, bn_momentum=bn_momentum, dropout=dropout,
            output_bias=output_bias, remat=remat,
        )
        self.remat = remat
        self.head_kind = head
        self.threshold = threshold
        self.space_to_depth = space_to_depth
        self.fold_bn = fold_bn
        self.levels = len(filters)

        ch = in_channels * (4 if space_to_depth else 1)
        for i, (feat, factor) in enumerate(zip(filters, factors)):
            self.add_module(f"EncoderBlock_{i}", EncoderBlock(
                ch, feat, factor, convs_per_block, fold_bn, bn_momentum))
            ch = feat
        self.ConvBlock_0 = ConvBlock(ch, filters[-1] * 2, convs_per_block, fold_bn,
                                     bn_momentum)
        ch = filters[-1] * 2
        for i, (feat, factor) in enumerate(zip(reversed(filters), reversed(factors))):
            self.add_module(f"DecoderBlock_{i}", DecoderBlock(
                ch, feat, feat, factor, fold_bn, bn_momentum, dropout))
            ch = feat
        if space_to_depth:
            self.stem_upsample = nn.ConvTranspose2d(ch, filters[0], 2, stride=2)
            self.stem_upsample_bn = None if fold_bn else _bn(filters[0], bn_momentum)
            ch = filters[0]
        self.dropout = None if dropout is None else nn.Dropout2d(dropout)
        self.head = nn.Conv2d(ch, n_classes, 1)
        flax_init_(self, output_bias=output_bias)

    def forward(self, x: torch.Tensor):
        """(B, H, W, C) -> dict of (B, H, W, n_classes) outputs (float32;
        ``classes`` int32 of shape (B, H, W) for softmax)."""
        x = x.to(self.head.weight.dtype)
        if self.space_to_depth:
            x = space_to_depth(x)
        x = x.permute(0, 3, 1, 2)
        call = _remat if self.remat and self.training and torch.is_grad_enabled() else _plain

        skips = []
        for i in range(self.levels):
            x, skip = call(getattr(self, f"EncoderBlock_{i}"), x)
            skips.append(skip)
        x = call(self.ConvBlock_0, x)
        for i, skip in enumerate(reversed(skips)):
            x = call(getattr(self, f"DecoderBlock_{i}"), x, skip)
        if self.space_to_depth:
            if epilogue_route(self.stem_upsample, self.stem_upsample_bn is None, (x,),
                              self.stem_upsample.out_channels):
                x = conv_bias_relu_(self.stem_upsample, x)
            else:
                x = self.stem_upsample(x)
                if self.stem_upsample_bn is not None:
                    x = self.stem_upsample_bn(x)
                x = F.relu(x)
        if self.dropout is not None:
            x = self.dropout(x)

        logits = self.head(x).float().permute(0, 2, 3, 1).contiguous()
        if self.head_kind == "softmax":
            probs = torch.softmax(logits, dim=-1)
            classes = torch.argmax(probs, dim=-1).to(torch.int32)
            return {"logits": logits, "probs": probs, "classes": classes}
        if self.head_kind == "sigmoid":
            probs = torch.sigmoid(logits)
            classes = (probs > self.threshold).to(torch.int32)
            return {"logits": logits, "probs": probs, "classes": classes}
        return {"continuous": logits}


def unet_solar(in_channels: int = 6, **overrides) -> UNet:
    """Solar-array binary U-Net: 6-band Sentinel-2, threshold 0.9."""
    kwargs = dict(n_classes=1, head="sigmoid", threshold=0.9)
    kwargs.update(overrides)
    return UNet(in_channels, **kwargs)


def unet_parking(in_channels: int = 3, **overrides) -> UNet:
    """Parking-lot binary U-Net: NAIP RGB."""
    kwargs = dict(n_classes=1, head="sigmoid", threshold=0.5)
    kwargs.update(overrides)
    return UNet(in_channels, **kwargs)

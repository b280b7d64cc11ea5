"""The hybrid U-Net + ConvLSTM model.

Port of ``satellite_computervision_tpu/models/hybrid.py`` (the reference's
get_hybrid_model, utils/model_tools.py:874-920): a U-Net branch over
high-resolution imagery (NAIP) and a ConvLSTM branch over a coarser
series (S2/S1), each reduced to ``n_classes`` channels by a 1x1 ReLU conv;
the LSTM's map is nearest-resized onto the U-Net grid
(``blocks.resize_nearest``: ``jax.image.resize``'s nearest is torch's
``"nearest-exact"``), concatenated before the U-Net's, and fused by a 1x1
softmax conv.

The U-Net trunk pools by ``factors`` (3, 2, 2, 2) and floors as flax's
VALID max-pool does, so only a side that survives the round trip (a
multiple of 24 for the default factors) concatenates with its skip on the
way up; any other side raises a ``ValueError`` where the JAX model fails
to concatenate (the landcover and wetland presets' 256² among them).
Module names follow the flax tree (``unet.EncoderBlock_0``,
``LSTMStack_0``, ``unet_dense``, ``lstm_dense``, ``probabilities``); the
factor-3 transposed conv takes the flipped flax kernel like the others
(``models.bridge``). NHWC in and out, NCHW inside.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from satellite_computervision_tpu_torch.models.blocks import (
    ConvBlock,
    DecoderBlock,
    EncoderBlock,
    resize_nearest,
)
from satellite_computervision_tpu_torch.models.convlstm import LSTMStack, _seq_to_nchw
from satellite_computervision_tpu_torch.models.unet import flax_init_


class UNetTrunk(nn.Module):
    """The U-Net of build_unet_layers without a head: NCHW in, the last
    decoder's ``filters[0]`` channels out."""

    def __init__(self, in_ch: int, filters: Sequence[int] = (32, 64, 128, 256),
                 factors: Sequence[int] = (3, 2, 2, 2), dropout: Optional[float] = None,
                 convs_per_block: int = 2):
        super().__init__()
        self.factors = tuple(factors)
        ch = in_ch
        for i, (feat, factor) in enumerate(zip(filters, factors)):
            self.add_module(f"EncoderBlock_{i}", EncoderBlock(ch, feat, factor,
                                                              convs_per_block))
            ch = feat
        self.ConvBlock_0 = ConvBlock(ch, filters[-1] * 2, convs_per_block)
        ch = filters[-1] * 2
        for i, (feat, factor) in enumerate(zip(reversed(filters), reversed(factors))):
            self.add_module(f"DecoderBlock_{i}", DecoderBlock(ch, feat, feat, factor,
                                                              dropout=dropout))
            ch = feat

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        side = tuple(x.shape[2:])
        skips = []
        for i in range(len(self.factors)):
            x, skip = getattr(self, f"EncoderBlock_{i}")(x)
            skips.append(skip)
        x = self.ConvBlock_0(x)
        for i, (skip, factor) in enumerate(zip(reversed(skips), reversed(self.factors))):
            up = (x.shape[2] * factor, x.shape[3] * factor)
            if up != tuple(skip.shape[2:]):
                raise ValueError(
                    f"a U-Net input of {side[0]}x{side[1]} does not survive the pool factors "
                    f"{self.factors}: the {tuple(skip.shape[2:])} level pools to "
                    f"{tuple(x.shape[2:])} and upsamples to {up}, which cannot be "
                    "concatenated with its skip; give a side divisible by the product "
                    "of the factors")
            x = getattr(self, f"DecoderBlock_{i}")(x, skip)
        return x


class HybridUNetLSTM(nn.Module):
    """``forward(unet_input (B, H, W, C), lstm_input (B, T, h, w, S))`` ->
    ``logits``/``probs`` (B, H, W, n_classes) float32 and ``classes`` (B, H,
    W) int32. ``convs_per_block=1`` is the reference's conv_block
    double-call layout, as in JAX."""

    def __init__(self, in_channels: int, series_channels: int, n_classes: int,
                 filters: Sequence[int] = (32, 64, 128, 256),
                 factors: Sequence[int] = (3, 2, 2, 2), lstm_features: int = 64,
                 dropout: Optional[float] = None, convs_per_block: int = 2):
        super().__init__()
        self.kwargs = dict(in_channels=in_channels, series_channels=series_channels,
                           n_classes=n_classes, filters=tuple(filters), factors=tuple(factors),
                           lstm_features=lstm_features, dropout=dropout,
                           convs_per_block=convs_per_block)
        self.unet = UNetTrunk(in_channels, filters, factors, dropout, convs_per_block)
        self.dropout = None if dropout is None else nn.Dropout2d(dropout)
        self.unet_dense = nn.Conv2d(filters[0], n_classes, 1)
        self.LSTMStack_0 = LSTMStack(series_channels, lstm_features, dropout=dropout)
        self.lstm_dense = nn.Conv2d(lstm_features, n_classes, 1)
        self.probabilities = nn.Conv2d(2 * n_classes, n_classes, 1)
        flax_init_(self)

    def forward(self, unet_input: torch.Tensor, lstm_input: torch.Tensor):
        dtype = self.probabilities.weight.dtype
        unet_out = self.unet(unet_input.to(dtype).permute(0, 3, 1, 2))
        lstm_out = self.LSTMStack_0(_seq_to_nchw(lstm_input.to(dtype)))
        if self.dropout is not None:
            unet_out, lstm_out = self.dropout(unet_out), self.dropout(lstm_out)
        unet_dense = F.relu(self.unet_dense(unet_out))
        lstm_dense = F.relu(self.lstm_dense(lstm_out))
        lstm_resized = resize_nearest(lstm_dense, unet_dense.shape[2:])
        fused = torch.cat([lstm_resized, unet_dense.to(lstm_resized.dtype)], dim=1)
        logits = self.probabilities(fused).float().permute(0, 2, 3, 1)
        probs = torch.softmax(logits, dim=-1)
        return {"logits": logits, "probs": probs,
                "classes": torch.argmax(probs, dim=-1).to(torch.int32)}

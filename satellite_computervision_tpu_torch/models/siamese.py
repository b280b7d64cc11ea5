"""Siamese U-Net with ASPP for change detection.

Port of ``satellite_computervision_tpu/models/siamese.py``. One encoder
tower, its weights shared, runs over the before and the after image; each
level's skip is ``cat([skip_before, skip_after])``; one shared ASPP runs
over both bottlenecks and its two outputs are concatenated into the
decoder's input (there is no bottleneck ``ConvBlock``); a 1x1 sigmoid head
gives the change probability.

- Sharing is one module applied twice, as in flax. In train mode each call
  normalizes with its own tower's batch statistics and updates the running
  statistics once: the after tower first, then the before tower, the
  order in which the JAX model applies them (flax's mutable
  ``batch_stats``).
- The public forward keeps the JAX layout: ``forward(before, after)``, NHWC
  in, a dict of NHWC float32 ``logits``/``probs`` and int32 ``classes``
  out. Inputs are cast to the parameters' dtype, as ``UNet`` does.
- A new model starts from flax's default initialization
  (``unet.flax_init_``), the head's bias ``output_bias`` when given.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from satellite_computervision_tpu_torch.models.blocks import (
    ASPP,
    BN_MOMENTUM,
    DecoderBlock,
    EncoderBlock,
)
from satellite_computervision_tpu_torch.models.unet import flax_init_


class SiameseUNet(nn.Module):
    def __init__(
        self,
        in_channels: int = 4,
        filters: Sequence[int] = (32, 64, 128),
        factors: Sequence[int] = (2, 2, 2),
        threshold: float = 0.5,
        output_bias: Optional[float] = None,
        convs_per_block: int = 2,
        bn_momentum: float = BN_MOMENTUM,
    ):
        super().__init__()
        if len(filters) != len(factors):
            raise ValueError("filters and factors must be the same length")
        self.kwargs = dict(
            in_channels=in_channels, filters=tuple(filters), factors=tuple(factors),
            threshold=threshold, output_bias=output_bias, convs_per_block=convs_per_block,
            bn_momentum=bn_momentum,
        )
        self.threshold = threshold
        self.levels = len(filters)

        ch = in_channels
        for i, (feat, factor) in enumerate(zip(filters, factors)):
            self.add_module(f"encoder_{i}", EncoderBlock(
                ch, feat, factor, convs_per_block, bn_momentum=bn_momentum))
            ch = feat
        self.aspp = ASPP(ch, filters[-1] * 2, bn_momentum=bn_momentum)
        ch = filters[-1] * 4  # both towers' ASPP outputs
        for i, (feat, factor) in enumerate(zip(reversed(filters), reversed(factors))):
            self.add_module(f"DecoderBlock_{i}", DecoderBlock(
                ch, 2 * feat, feat, factor, bn_momentum=bn_momentum))
            ch = feat
        self.head = nn.Conv2d(ch, 1, 1)
        flax_init_(self, output_bias=output_bias)

    def forward(self, before: torch.Tensor, after: torch.Tensor):
        """(B, H, W, C) before and after -> dict of (B, H, W, 1) outputs."""
        dtype = self.head.weight.dtype
        a = after.to(dtype).permute(0, 3, 1, 2)
        b = before.to(dtype).permute(0, 3, 1, 2)

        skips = []
        for i in range(self.levels):
            encoder = getattr(self, f"encoder_{i}")
            a, skip_a = encoder(a)
            b, skip_b = encoder(b)
            skips.append(torch.cat([skip_b, skip_a], dim=1))
        aspp_a = self.aspp(a)
        aspp_b = self.aspp(b)
        x = torch.cat([aspp_b, aspp_a], dim=1)
        for i, skip in enumerate(reversed(skips)):
            x = getattr(self, f"DecoderBlock_{i}")(x, skip)

        logits = self.head(x).float().permute(0, 2, 3, 1).contiguous()
        probs = torch.sigmoid(logits)
        classes = (probs > self.threshold).to(torch.int32)
        return {"logits": logits, "probs": probs, "classes": classes}

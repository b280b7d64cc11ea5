"""The atrous CNN (ACNN) and the hierarchical multi-head ACNN + ConvLSTM
model.

Port of ``satellite_computervision_tpu/models/acnn.py`` (the reference's
build_acnn_layers / build_acnn_layers2 / get_acnn_model2 /
get_hierarchical_model, utils/model_tools.py:922-1051). Blocks alternate a
plain 3x3 conv (with an additive residual accumulation) and a 3x3 conv
dilated 3, each followed by BatchNorm (momentum 0.99, eps 1e-3, as the JAX
blocks). Module names follow the flax tree (``trunk.conv_{b}_1``,
``trunk.bn_{b}_1``, ``trunk.dilated_conv_{b}_2``, ``head``, ``sub_head``,
``LSTMStack_0`` ...) for ``models.bridge.flax_to_torch``. Inputs and
outputs are NHWC, as in JAX; inside, NCHW. A new model starts from flax's
default initialization (``unet.flax_init_``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from satellite_computervision_tpu_torch.models.blocks import _bn, resize_nearest
from satellite_computervision_tpu_torch.models.convlstm import LSTMStack, _seq_to_nchw
from satellite_computervision_tpu_torch.models.unet import flax_init_


class ACNNTrunk(nn.Module):
    """The conv / dilated-conv residual block stack; ``forward`` returns the
    activated features after each block (NCHW), so heads can tap any depth.

    ``variant=2`` (build_acnn_layers2): each block's plain conv takes the
    previous block's activated output. ``variant=1`` (build_acnn_layers):
    it takes the previous block's raw dilated-conv output."""

    def __init__(self, in_ch: int, n_blocks: int = 16, features: int = 16,
                 kernel_size: int = 3, variant: int = 2):
        super().__init__()
        self.n_blocks = n_blocks
        self.variant = variant
        for block in range(n_blocks):
            self.add_module(f"conv_{block}_1", nn.Conv2d(
                in_ch if block == 0 else features, features, kernel_size, padding="same"))
            self.add_module(f"bn_{block}_1", _bn(features))
            self.add_module(f"dilated_conv_{block}_2", nn.Conv2d(
                features, features, kernel_size, padding="same", dilation=3))
            self.add_module(f"bn_{block}_2", _bn(features))

    def forward(self, x: torch.Tensor):
        conv_in, features_add, taps = x, None, []
        for block in range(self.n_blocks):
            normed = getattr(self, f"bn_{block}_1")(getattr(self, f"conv_{block}_1")(conv_in))
            features_add = F.relu(normed if block == 0 else normed + features_add)
            feats = getattr(self, f"dilated_conv_{block}_2")(features_add)
            activated = F.relu(getattr(self, f"bn_{block}_2")(feats))
            conv_in = feats if self.variant == 1 else activated
            taps.append(activated)
        return taps


def _softmax_head(logits: torch.Tensor):
    """NCHW logits -> the float32 NHWC ``logits``/``probs`` and int32
    ``classes`` of a softmax head."""
    logits = logits.float().permute(0, 2, 3, 1)
    probs = torch.softmax(logits, dim=-1)
    return {"logits": logits, "probs": probs,
            "classes": torch.argmax(probs, dim=-1).to(torch.int32)}


class ACNN(nn.Module):
    """The ACNN with a 1x1 softmax head (get_acnn_model2): (B, H, W, C) ->
    ``logits``/``probs`` (B, H, W, n_classes) and ``classes`` (B, H, W)."""

    def __init__(self, in_channels: int, n_classes: int, n_blocks: int = 16,
                 features: int = 16):
        super().__init__()
        self.kwargs = dict(in_channels=in_channels, n_classes=n_classes, n_blocks=n_blocks,
                           features=features)
        self.trunk = ACNNTrunk(in_channels, n_blocks, features)
        self.head = nn.Conv2d(features, n_classes, 1)
        flax_init_(self)

    def forward(self, x: torch.Tensor):
        taps = self.trunk(x.to(self.head.weight.dtype).permute(0, 3, 1, 2))
        return _softmax_head(self.head(taps[-1]))


class HierarchicalACNN(nn.Module):
    """The three-headed hierarchical model (get_hierarchical_model):

    - ``sub_probs``: softmax over ``sub_classes`` from the trunk's middle
      tap, block ``(n_blocks - 1) // 2``;
    - ``acnn_probs``: softmax over ``acnn_classes`` from the last tap;
    - ``lstm_probs``: softmax over ``n_classes`` from the last tap
      concatenated after an ``LSTMStack`` branch over the ``(B, T, h, w,
      C)`` series, nearest-resized to the trunk's grid.

    ``logits`` of each head beside them; all (B, H, W, classes) float32."""

    def __init__(self, in_channels: int, series_channels: int, n_classes: int,
                 acnn_classes: int, sub_classes: int, n_blocks: int = 16, features: int = 16,
                 lstm_features: int = 64):
        super().__init__()
        self.kwargs = dict(in_channels=in_channels, series_channels=series_channels,
                           n_classes=n_classes, acnn_classes=acnn_classes,
                           sub_classes=sub_classes, n_blocks=n_blocks, features=features,
                           lstm_features=lstm_features)
        self.midpoint = (n_blocks - 1) // 2
        self.trunk = ACNNTrunk(in_channels, n_blocks, features)
        self.sub_head = nn.Conv2d(features, sub_classes, 1)
        self.acnn_head = nn.Conv2d(features, acnn_classes, 1)
        self.LSTMStack_0 = LSTMStack(series_channels, lstm_features)
        self.lstm_head = nn.Conv2d(lstm_features + features, n_classes, 1)
        flax_init_(self)

    def forward(self, x: torch.Tensor, timeseries: torch.Tensor):
        dtype = self.lstm_head.weight.dtype
        taps = self.trunk(x.to(dtype).permute(0, 3, 1, 2))
        last = taps[-1]
        lstm_out = self.LSTMStack_0(_seq_to_nchw(timeseries.to(dtype)))
        lstm_resized = resize_nearest(lstm_out, last.shape[2:])
        out = {}
        for name, logits in (
                ("sub", self.sub_head(taps[self.midpoint])),
                ("acnn", self.acnn_head(last)),
                ("lstm", self.lstm_head(torch.cat([lstm_resized, last.to(lstm_resized.dtype)],
                                                  dim=1)))):
            logits = logits.float().permute(0, 2, 3, 1)
            out[f"{name}_probs"] = torch.softmax(logits, dim=-1)
            out[f"{name}_logits"] = logits
        return out

"""ConvLSTM models: the stacked ConvLSTM, the LSTM regression model and the
LSTM autoencoder.

Port of ``satellite_computervision_tpu/models/convlstm.py`` (the
reference's build_lstm_layers / build_lstm_layers2 / get_lstm_model /
get_lstm_autoencoder, utils/model_tools.py:666-872). The cell follows Keras
ConvLSTM2D as the reference uses it: no cell or output activation, the
``hard_sigmoid`` recurrent activation, a unit forget bias added at run
time, the dilation on the input convolution only.

- Keras's ``hard_sigmoid`` is ``clip(0.2 x + 0.5, 0, 1)``; torch's
  ``F.hardsigmoid`` is ``clip(x / 6 + 0.5, 0, 1)``, another function, so
  it is not used.
- The recurrence is a Python loop over the time axis (T is 5 or 6); the
  input convolution has no recurrence, so it runs once over all ``B*T``
  steps and each step adds the recurrent convolution of ``h`` (the same
  sum ``input + recurrent`` per element as the JAX cell).
- Gates split as i, f, g, o along the channels (``torch.chunk`` on NCHW,
  ``jnp.split`` on NHWC in JAX). The carry ``(c, h)`` starts at zeros.
- The carry is kept in the wider of float32 and the parameters' dtype:
  under bf16 autocast the gates are bfloat16 but ``c`` and ``h`` stay
  float32 across the steps (the JAX model with ``dtype=bfloat16`` keeps a
  bfloat16 carry); a bfloat16 or float64 model keeps its own dtype.
- BatchNorm over a ``(B, T, C, H, W)`` sequence reduces over ``B*T*H*W``:
  the sequence is flattened to ``(B*T, C, H, W)`` for ``blocks.BatchNorm``
  (momentum 0.99, eps 1e-3, flax's running-variance update).
- Module names follow the flax tree (``ConvLSTM_0.cell.input_conv``,
  ``BatchNorm_1``, ``lstm_decoder``, ``temporal_dense`` ...), so
  ``models.bridge.flax_to_torch`` maps a JAX tree by name.

The public models take the JAX layout, ``(B, T, H, W, C)`` series (and
``(B, H, W, 2)`` harmonics), and return float32 NHWC outputs; inside, the
sequence runs as ``(B, T, C, H, W)``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from satellite_computervision_tpu_torch.models.blocks import _bn
from satellite_computervision_tpu_torch.models.unet import flax_init_


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Keras's ``hard_sigmoid``: ``clip(0.2 x + 0.5, 0, 1)``."""
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def capped_relu(x: torch.Tensor, cap: float = 2.0) -> torch.Tensor:
    """ReLU(max_value=2.0), the reference's final LSTM activation."""
    return torch.clamp(x, 0.0, cap)


def _seq_to_nchw(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, T, C, H, W) (a view)."""
    return x.permute(0, 1, 4, 2, 3)


class ConvLSTMCell(nn.Module):
    """The two SAME convolutions of one ConvLSTM step: ``input_conv``
    (dilated, with a bias) on the input, ``recurrent_conv`` (no bias, no
    dilation) on ``h``."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3, dilation: int = 1):
        super().__init__()
        self.features = features
        self.input_conv = nn.Conv2d(in_ch, 4 * features, kernel_size, padding="same",
                                    dilation=dilation)
        self.recurrent_conv = nn.Conv2d(features, 4 * features, kernel_size, padding="same",
                                        bias=False)

    def step(self, carry, x_gates: torch.Tensor):
        """One step from the input's gate pre-activations ``x_gates``
        (``input_conv`` of the step's input): returns the new ``(c, h)``."""
        c, h = carry
        gates = x_gates + self.recurrent_conv(h)
        i, f, g, o = torch.chunk(gates, 4, dim=1)
        i = hard_sigmoid(i)
        f = hard_sigmoid(f + 1.0)  # unit forget bias
        o = hard_sigmoid(o)
        c = f * c + i * g  # no activation on g
        h = o * c  # nor on the cell state
        return c, h

    def forward(self, carry, x: torch.Tensor):
        """One step on the input ``x`` (B, C, H, W): ``((c, h), h)``."""
        c, h = self.step(carry, self.input_conv(x))
        return (c, h), h


class ConvLSTM(nn.Module):
    """ConvLSTM over a ``(B, T, C, H, W)`` sequence. Returns ``(h_seq or
    h_last, (c_last, h_last))``, ``h_seq`` of shape (B, T, F, H, W), as
    Keras's ConvLSTM2D with ``return_sequences``."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3, dilation: int = 1,
                 return_sequences: bool = False):
        super().__init__()
        self.features = features
        self.return_sequences = return_sequences
        self.cell = ConvLSTMCell(in_ch, features, kernel_size, dilation)

    def forward(self, x: torch.Tensor):
        b, t, _, hgt, wid = x.shape
        x_gates = self.cell.input_conv(x.flatten(0, 1)).unflatten(0, (b, t))
        dtype = torch.promote_types(x_gates.dtype, self.cell.recurrent_conv.weight.dtype)
        c = h = torch.zeros((b, self.features, hgt, wid), dtype=dtype, device=x.device)
        hs = []
        for s in range(t):
            c, h = self.cell.step((c, h), x_gates[:, s])
            hs.append(h)
        out = torch.stack(hs, dim=1) if self.return_sequences else h
        return out, (c, h)


def _seq_bn(bn: nn.Module, seq: torch.Tensor) -> torch.Tensor:
    """BatchNorm of a (B, T, C, H, W) sequence over B*T*H*W."""
    return bn(seq.flatten(0, 1)).unflatten(0, seq.shape[:2])


class LSTMStack(nn.Module):
    """ConvLSTM -> BN -> ReLU [-> dropout] -> ConvLSTM (input dilated 3) ->
    BN -> ReLU (build_lstm_layers). Takes (B, T, C, H, W); returns
    (B, F, H, W), or (B, T, F, H, W) with ``return_sequences``."""

    def __init__(self, in_ch: int, features: int = 64, return_sequences: bool = False,
                 dropout: Optional[float] = None):
        super().__init__()
        self.return_sequences = return_sequences
        self.ConvLSTM_0 = ConvLSTM(in_ch, features, return_sequences=True)
        self.BatchNorm_0 = _bn(features)
        self.dropout = None if dropout is None else nn.Dropout(dropout)
        self.ConvLSTM_1 = ConvLSTM(features, features, dilation=3,
                                   return_sequences=return_sequences)
        self.BatchNorm_1 = _bn(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seq, _ = self.ConvLSTM_0(x)
        y = F.relu(_seq_bn(self.BatchNorm_0, seq))
        if self.dropout is not None:
            y = self.dropout(y)
        out, _ = self.ConvLSTM_1(y)
        out = _seq_bn(self.BatchNorm_1, out) if self.return_sequences else self.BatchNorm_1(out)
        return F.relu(out)


class LSTMStack2(nn.Module):
    """The residual variant: ``relu(h_last of the first ConvLSTM + BN(the
    second's output))`` (build_lstm_layers2). Takes (B, T, C, H, W);
    returns (B, F, H, W)."""

    def __init__(self, in_ch: int, features: int = 16, dropout: Optional[float] = None):
        super().__init__()
        self.ConvLSTM_0 = ConvLSTM(in_ch, features, return_sequences=True)
        self.BatchNorm_0 = _bn(features)
        self.dropout = None if dropout is None else nn.Dropout(dropout)
        self.ConvLSTM_1 = ConvLSTM(features, features, dilation=3)
        self.BatchNorm_1 = _bn(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seq, (_, state_h) = self.ConvLSTM_0(x)
        y = F.relu(_seq_bn(self.BatchNorm_0, seq))
        if self.dropout is not None:
            y = self.dropout(y)
        out, _ = self.ConvLSTM_1(y)
        return F.relu(state_h + self.BatchNorm_1(out))


class LSTMModel(nn.Module):
    """(B, T, H, W, C) -> per-pixel regression (B, H, W, n_classes) capped
    at ``cap`` (get_lstm_model); float32 out."""

    def __init__(self, in_channels: int, n_classes: int, features: int = 64, cap: float = 2.0,
                 dropout: Optional[float] = None):
        super().__init__()
        self.kwargs = dict(in_channels=in_channels, n_classes=n_classes, features=features,
                           cap=cap, dropout=dropout)
        self.cap = cap
        self.LSTMStack_0 = LSTMStack(in_channels, features, dropout=dropout)
        self.dropout = None if dropout is None else nn.Dropout2d(dropout)
        self.Conv_0 = nn.Conv2d(features, n_classes, 1)
        flax_init_(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.LSTMStack_0(_seq_to_nchw(x.to(self.Conv_0.weight.dtype)))
        if self.dropout is not None:
            y = self.dropout(y)
        y = self.Conv_0(y).float().permute(0, 2, 3, 1)
        return capped_relu(y, self.cap)


class LSTMAutoencoder(nn.Module):
    """The two-headed ConvLSTM autoencoder (get_lstm_autoencoder):

    - ``temporal``: the encoded state repeated ``n_time`` times -> a
      ConvLSTM(32) decoder -> a 1x1 conv on every step (the reversed
      sequence), (B, n_time, H, W, n_classes);
    - ``single``: the encoded state concatenated with the (B, H, W, 2)
      sin/cos harmonics -> a 1x1 conv (the next step), (B, H, W,
      n_classes).

    Both capped at ``cap``, float32."""

    def __init__(self, in_channels: int, n_classes: int, n_time: int, features: int = 16,
                 cap: float = 2.0):
        super().__init__()
        self.kwargs = dict(in_channels=in_channels, n_classes=n_classes, n_time=n_time,
                           features=features, cap=cap)
        self.n_time = n_time
        self.cap = cap
        self.LSTMStack2_0 = LSTMStack2(in_channels, features)
        self.lstm_decoder = ConvLSTM(features, 32, return_sequences=True)
        self.temporal_dense = nn.Conv2d(32, n_classes, 1)
        self.single_dense = nn.Conv2d(features + 2, n_classes, 1)
        flax_init_(self)

    def forward(self, x: torch.Tensor, sincos: torch.Tensor):
        dtype = self.single_dense.weight.dtype
        encoded = self.LSTMStack2_0(_seq_to_nchw(x.to(dtype)))  # (B, F, H, W)
        b, t = encoded.shape[0], self.n_time
        repeated = encoded[:, None].expand(b, t, *encoded.shape[1:])
        decoded, _ = self.lstm_decoder(repeated)  # (B, T, 32, H, W)
        # TimeDistributed(1x1 conv): pointwise, so one conv over B*T
        temporal = self.temporal_dense(decoded.flatten(0, 1)).unflatten(0, (b, t))
        temporal = capped_relu(temporal.float().permute(0, 1, 3, 4, 2), self.cap)
        concat = torch.cat([encoded, sincos.to(encoded.dtype).permute(0, 3, 1, 2)], dim=1)
        single = self.single_dense(concat).float().permute(0, 2, 3, 1)
        return {"temporal": temporal, "single": capped_relu(single, self.cap)}

"""Shared convolutional building blocks (PyTorch, NCHW inside).

Port of ``satellite_computervision_tpu/models/blocks.py`` (ConvBNAct,
ConvBlock, EncoderBlock, DecoderBlock, ASPP). Sub-module names follow the
flax parameter tree (``Conv_0``, ``BatchNorm_0``, ``ConvTranspose_0``,
``affine_0_scale`` ...) so a ``state_dict`` key reads like the JAX path it
came from (models/bridge.py maps one onto the other).

- BatchNorm uses the Keras epsilon 1e-3, as the JAX blocks do, and takes
  the flax/Keras ``bn_momentum`` (the weight of the old running value;
  torch's ``momentum`` is ``1 - bn_momentum``). In training it updates the
  running variance with the biased batch variance, as flax does
  (``BatchNorm`` below); torch's own update uses the unbiased one.
- ``dropout`` is channel dropout (flax ``Dropout(broadcast_dims=(1, 2))``
  on NHWC = ``nn.Dropout2d`` on NCHW) after the decoder's post-concat BN.
- ``fold_bn=True`` is the serving mode: the BatchNorms are gone (their
  affine lives in the conv weights, models/fold.py), and the decoder's
  post-concat BN is a per-channel affine ``affine_0_scale/bias``.
- Blocks take and return NCHW tensors; the UNet converts at its edges.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-3  # Keras default, as blocks.py uses


BN_MOMENTUM = 0.99  # Keras default, as blocks.py uses


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training-mode running-variance update uses
    the biased batch variance, as flax's ``BatchNorm`` does.

    Torch's kernel updates ``running_var`` with ``(1-m)*rv + m*u``, ``u``
    the unbiased variance ``n/(n-1)`` times the biased one ``v``; the
    flax update is ``(1-m)*rv + m*v``. The difference is ``m*u/n``, which
    is recovered from the updated buffer and subtracted: a per-channel
    correction, no second pass over the activations.

    One value per channel (DeepLab's image-pooling branch at batch 1) is
    normalized as flax does it: to 0, so the output is the bias, and the
    running variance is updated with a batch variance of 0; torch's kernel
    refuses such a batch."""

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        n = x.numel() // x.shape[1]
        if n == 1:
            return self._one_value(x)
        # the kernel updates this copy in place to (1-m)*running_var + m*u;
        # autograd keeps it, so the buffer itself is written afterwards
        updated = self.running_var.clone()
        out = F.batch_norm(x, self.running_mean, updated, self.weight, self.bias, True,
                           self.momentum, self.eps)
        with torch.no_grad():
            self.running_var.copy_(
                updated - (updated - (1.0 - self.momentum) * self.running_var) / n)
        return out

    def _one_value(self, x):
        """Train-mode BN of a batch holding one value per channel, in flax's
        formulation: ``x - mean`` is exactly 0, so are its gradients."""
        dims = (0, 2, 3)
        centred = x - x.mean(dim=dims, keepdim=True)
        var = centred.square().mean(dim=dims)
        scale = torch.rsqrt(var + self.eps) * self.weight
        out = centred * scale[None, :, None, None] + self.bias[None, :, None, None]
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(m * x.mean(dim=dims).float())
            self.running_var.mul_(1.0 - m).add_(m * var.float())
        return out.to(x.dtype)


def _bn(ch: int, bn_momentum: float = BN_MOMENTUM) -> BatchNorm:
    return BatchNorm(ch, eps=BN_EPS, momentum=1.0 - bn_momentum)


class ConvBNAct(nn.Module):
    """Conv2D(SAME, dilation) -> BatchNorm -> ReLU.

    ``padding="same"`` pads ``dilation * (kernel_size - 1)`` in all, half
    on each side, as flax's ``padding="SAME"`` with ``kernel_dilation``
    does for the odd kernel sizes used here."""

    def __init__(self, in_ch: int, features: int, fold_bn: bool = False,
                 bn_momentum: float = BN_MOMENTUM, kernel_size: int = 3, dilation: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_ch, features, kernel_size, padding="same", dilation=dilation)
        self.BatchNorm_0 = None if fold_bn else _bn(features, bn_momentum)

    def forward(self, x):
        x = self.Conv_0(x)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x)
        return F.relu(x)


class ConvBlock(nn.Module):
    """n x (conv -> BN -> relu)."""

    def __init__(self, in_ch: int, features: int, n_convs: int = 2,
                 fold_bn: bool = False, bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        self.n_convs = n_convs
        for i in range(n_convs):
            self.add_module(
                f"ConvBNAct_{i}",
                ConvBNAct(in_ch if i == 0 else features, features, fold_bn=fold_bn,
                          bn_momentum=bn_momentum),
            )

    def forward(self, x):
        for i in range(self.n_convs):
            x = getattr(self, f"ConvBNAct_{i}")(x)
        return x


class EncoderBlock(nn.Module):
    """conv_block -> max_pool(factor); returns (pooled, skip)."""

    def __init__(self, in_ch: int, features: int, pool: int = 2,
                 n_convs: int = 2, fold_bn: bool = False,
                 bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        self.pool = pool
        self.ConvBlock_0 = ConvBlock(in_ch, features, n_convs, fold_bn, bn_momentum)

    def forward(self, x):
        skip = self.ConvBlock_0(x)
        return F.max_pool2d(skip, self.pool, self.pool), skip


class DecoderBlock(nn.Module):
    """transpose_conv -> concat [skip, up] -> BN -> relu [-> channel dropout]
    -> 2x(conv->BN->relu).

    With ``fold_bn`` the post-concat BN (it normalizes skip channels too,
    so it has no single preceding conv to fold into) is the per-channel
    affine ``affine_0_scale``/``affine_0_bias``."""

    def __init__(self, in_ch: int, skip_ch: int, features: int, up: int = 2,
                 fold_bn: bool = False, bn_momentum: float = BN_MOMENTUM,
                 dropout: Optional[float] = None):
        super().__init__()
        cat = skip_ch + features
        self.fold_bn = fold_bn
        self.ConvTranspose_0 = nn.ConvTranspose2d(in_ch, features, up, stride=up)
        if fold_bn:
            self.affine_0_scale = nn.Parameter(torch.ones(cat))
            self.affine_0_bias = nn.Parameter(torch.zeros(cat))
        else:
            self.BatchNorm_0 = _bn(cat, bn_momentum)
            self.BatchNorm_1 = _bn(features, bn_momentum)
            self.BatchNorm_2 = _bn(features, bn_momentum)
        self.dropout = None if dropout is None else nn.Dropout2d(dropout)
        self.Conv_0 = nn.Conv2d(cat, features, 3, padding="same")
        self.Conv_1 = nn.Conv2d(features, features, 3, padding="same")

    def forward(self, x, skip):
        x = torch.cat([skip, self.ConvTranspose_0(x)], dim=1)
        if self.fold_bn:
            x = x * self.affine_0_scale[:, None, None] + self.affine_0_bias[:, None, None]
        else:
            x = self.BatchNorm_0(x)
        x = F.relu(x)
        if self.dropout is not None:
            x = self.dropout(x)
        for i in range(2):
            x = getattr(self, f"Conv_{i}")(x)
            if not self.fold_bn:
                x = getattr(self, f"BatchNorm_{i + 1}")(x)
            x = F.relu(x)
        return x


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: parallel 1x1 and 3x3 dilated
    (``rates``) conv->BN->relu branches, optionally a global-average-pool
    branch (``image_pooling``), concatenated, then fused by a 1x1
    conv->BN->relu.

    Children are numbered in flax's creation order: ``ConvBNAct_0`` the
    1x1 branch, ``ConvBNAct_1..len(rates)`` the dilated ones, then the
    pool branch when present, then the fuse."""

    def __init__(self, in_ch: int, features: int, rates=(3, 6, 12), image_pooling: bool = False,
                 bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        self.image_pooling = image_pooling
        self.n_branches = 1 + len(rates)
        cba = dict(bn_momentum=bn_momentum)
        self.ConvBNAct_0 = ConvBNAct(in_ch, features, kernel_size=1, **cba)
        for i, rate in enumerate(rates, start=1):
            self.add_module(f"ConvBNAct_{i}", ConvBNAct(in_ch, features, dilation=rate, **cba))
        fuse = self.n_branches + image_pooling
        if image_pooling:
            self.add_module(f"ConvBNAct_{self.n_branches}",
                            ConvBNAct(in_ch, features, kernel_size=1, **cba))
        self.add_module(f"ConvBNAct_{fuse}",
                        ConvBNAct(features * fuse, features, kernel_size=1, **cba))
        self.n_fuse = fuse

    def forward(self, x):
        branches = [getattr(self, f"ConvBNAct_{i}")(x) for i in range(self.n_branches)]
        if self.image_pooling:
            pooled = getattr(self, f"ConvBNAct_{self.n_branches}")(
                x.mean(dim=(2, 3), keepdim=True))
            branches.append(pooled.expand(-1, -1, x.shape[2], x.shape[3]))
        return getattr(self, f"ConvBNAct_{self.n_fuse}")(torch.cat(branches, dim=1))

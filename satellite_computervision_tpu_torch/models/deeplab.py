"""DeepLab v3+ with a ResNet backbone (the parking-lot model).

Port of ``satellite_computervision_tpu/models/deeplab.py``:

- a ResNet-50/101 backbone (``stage_sizes``) at output stride 16: stage 4
  trades its stride for dilation 2; it returns C2 (stride 4) and C5;
- the port's ``blocks.ASPP`` with image pooling over C5, rates
  (6, 12, 18), with the blocks' BatchNorm (eps 1e-3, momentum 0.99);
- the decoder: the ASPP output resized to C2, concatenated with a 48-channel
  projection of C2, two 3x3 conv -> BN -> relu, a 1x1 head, the logits
  resized to the input side.

The backbone, ``low_bn`` and ``decoder_bn*`` use eps 1e-5 and momentum 0.9,
as the JAX model does; their convs have no bias. Module names follow the
flax tree (``backbone.stage2_block0.conv2``, ``aspp.ConvBNAct_4``,
``decoder_conv1`` ...), so ``models.bridge.flax_to_torch`` maps a JAX tree
unchanged.

XLA's "SAME" padding is asymmetric on strided layers: it pads
``total = max((ceil(n/s) - 1)*s + (k - 1)*d + 1 - n, 0)``, ``total // 2``
before and the rest after, so the 7x7 stride-2 stem pads (2, 3) on an even
side and the stride-2 3x3 convs and max-pool (0, 1). :class:`SameConv2d`
and :func:`max_pool_same` pad explicitly from the input's side (the pool
with -inf); stride-1 convs pad symmetrically, which SAME is for odd
kernels. The resizes are ``jax.image.resize(..., "bilinear")`` when
upsampling: half-pixel centres, edge samples clamped
(:func:`resize_bilinear`).

The public forward keeps the JAX layout: NHWC in, a dict of NHWC float32
``logits``/``probs`` and ``classes`` out (int32; ``(B, H, W)`` for
softmax, ``(B, H, W, 1)`` for sigmoid). The image-pooling branch averages
over the whole input, so unlike the U-Net the model is not fully
convolutional: its map depends a little on the chip geometry.

:func:`load_torch_resnet_weights` and :func:`export_torch_resnet_weights`
read and write a torchvision-layout ResNet ``state_dict`` (``.pth``) for the
backbone: the warm start from a pretrained ResNet, with no download.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from satellite_computervision_tpu_torch.models.blocks import ASPP, BatchNorm
from satellite_computervision_tpu_torch.models.unet import flax_init_

# the backbone's and decoder's BatchNorm (torchvision's ResNet settings)
RESNET_BN_EPS = 1e-5
RESNET_BN_MOMENTUM = 0.9


def _resnet_bn(ch: int) -> BatchNorm:
    return BatchNorm(ch, eps=RESNET_BN_EPS, momentum=1.0 - RESNET_BN_MOMENTUM)


def same_pads(size: int, kernel: int, stride: int = 1, dilation: int = 1) -> Tuple[int, int]:
    """(before, after) padding of XLA's "SAME" along a side of ``size``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: int, stride: int, dilation: int = 1,
             value: float = 0.0) -> torch.Tensor:
    """An NCHW tensor padded as XLA's "SAME" pads it for this window."""
    top, bottom = same_pads(x.shape[2], kernel, stride, dilation)
    left, right = same_pads(x.shape[3], kernel, stride, dilation)
    if not (top or bottom or left or right):
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def max_pool_same(x: torch.Tensor, kernel: int = 3, stride: int = 2) -> torch.Tensor:
    """flax ``max_pool(padding="SAME")``: padded with -inf, then pooled."""
    return F.max_pool2d(pad_same(x, kernel, stride, value=float("-inf")), kernel, stride)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` of an NCHW tensor to ``size``
    when upsampling: half-pixel centres, the triangle weights renormalized
    where they fall off the edge (the same as clamping the sample)."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False,
                         antialias=False)


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax's ``padding="SAME"``: symmetric for stride 1
    (odd kernels), padded explicitly from the input's side otherwise."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 dilation: int = 1, bias: bool = False):
        if stride == 1 and kernel_size % 2 == 0:
            raise ValueError("stride-1 SAME padding needs an odd kernel")
        pad = dilation * (kernel_size - 1) // 2 if stride == 1 else 0
        super().__init__(in_ch, out_ch, kernel_size, stride=stride, padding=pad,
                         dilation=dilation, bias=bias)

    def forward(self, x):
        if self.stride[0] != 1:
            x = pad_same(x, self.kernel_size[0], self.stride[0], self.dilation[0])
        return super().forward(x)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (stride, dilation) -> 1x1 (x4 channels), BN after each,
    plus the identity or a strided 1x1 projection (``downsample_conv``/
    ``downsample_bn``) where the channels or the stride change."""

    def __init__(self, in_ch: int, features: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.conv1 = SameConv2d(in_ch, features, 1)
        self.bn1 = _resnet_bn(features)
        self.conv2 = SameConv2d(features, features, 3, stride=stride, dilation=dilation)
        self.bn2 = _resnet_bn(features)
        self.conv3 = SameConv2d(features, features * 4, 1)
        self.bn3 = _resnet_bn(features * 4)
        self.downsample_conv = self.downsample_bn = None
        if in_ch != features * 4 or stride != 1:
            self.downsample_conv = SameConv2d(in_ch, features * 4, 1, stride=stride)
            self.downsample_bn = _resnet_bn(features * 4)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


# (features, stride, dilation) of the four stages at output stride 16
_PLAN = ((64, 1, 1), (128, 2, 1), (256, 2, 1), (512, 1, 2))


class ResNetBackbone(nn.Module):
    """ResNet-{50,101} feature extractor returning (C2, C5) at output
    stride (4, 16)."""

    def __init__(self, in_channels: int = 3, stage_sizes: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.stem_conv = SameConv2d(in_channels, 64, 7, stride=2)
        self.stem_bn = _resnet_bn(64)
        ch = 64
        for s, ((feat, stride, dilation), n) in enumerate(zip(_PLAN, self.stage_sizes), start=1):
            for b in range(n):
                self.add_module(f"stage{s}_block{b}", BottleneckBlock(
                    ch, feat, stride=stride if b == 0 else 1, dilation=dilation))
                ch = feat * 4
        self.out_channels = ch

    def forward(self, x):
        x = max_pool_same(F.relu(self.stem_bn(self.stem_conv(x))))
        c2 = None
        for s, n in enumerate(self.stage_sizes, start=1):
            for b in range(n):
                x = getattr(self, f"stage{s}_block{b}")(x)
            if s == 1:
                c2 = x
        return c2, x


class DeepLabV3Plus(nn.Module):
    def __init__(
        self,
        in_channels: int = 3,
        n_classes: int = 1,
        stage_sizes: Sequence[int] = (3, 4, 6, 3),
        aspp_features: int = 256,
        aspp_rates: Tuple[int, int, int] = (6, 12, 18),
        head: str = "sigmoid",
        threshold: float = 0.5,
    ):
        super().__init__()
        if head not in ("softmax", "sigmoid"):
            raise ValueError(f"unknown head {head!r}")
        self.kwargs = dict(
            in_channels=in_channels, n_classes=n_classes, stage_sizes=tuple(stage_sizes),
            aspp_features=aspp_features, aspp_rates=tuple(aspp_rates), head=head,
            threshold=threshold,
        )
        self.head_kind = head
        self.threshold = threshold
        self.backbone = ResNetBackbone(in_channels, stage_sizes)
        self.aspp = ASPP(self.backbone.out_channels, aspp_features, rates=tuple(aspp_rates),
                         image_pooling=True)
        low_ch = _PLAN[0][0] * 4  # C2: stage 1's output
        self.low_proj = SameConv2d(low_ch, 48, 1)
        self.low_bn = _resnet_bn(48)
        ch = aspp_features + 48
        for i in range(2):
            self.add_module(f"decoder_conv{i}", SameConv2d(ch, 256, 3))
            self.add_module(f"decoder_bn{i}", _resnet_bn(256))
            ch = 256
        self.head = nn.Conv2d(ch, n_classes, 1)
        flax_init_(self)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, H, W, C) -> dict of (B, H, W, n_classes) outputs."""
        x = x.to(self.head.weight.dtype).permute(0, 3, 1, 2)
        in_hw = x.shape[2:]
        c2, c5 = self.backbone(x)
        y = resize_bilinear(self.aspp(c5), c2.shape[2:])
        low = F.relu(self.low_bn(self.low_proj(c2)))
        y = torch.cat([y, low], dim=1)
        for i in range(2):
            y = F.relu(getattr(self, f"decoder_bn{i}")(getattr(self, f"decoder_conv{i}")(y)))
        logits = resize_bilinear(self.head(y), in_hw).float().permute(0, 2, 3, 1).contiguous()
        if self.head_kind == "softmax":
            probs = torch.softmax(logits, dim=-1)
            classes = torch.argmax(probs, dim=-1).to(torch.int32)
        else:
            probs = torch.sigmoid(logits)
            classes = (probs > self.threshold).to(torch.int32)
        return {"logits": logits, "probs": probs, "classes": classes}


# ---------------------------------------------------------------------------
# torchvision-layout ResNet weights for the backbone

_BN_TENSORS = ("weight", "bias", "running_mean", "running_var")


def torchvision_keys(model: DeepLabV3Plus) -> Dict[str, str]:
    """{torchvision ResNet key: the port's ``state_dict`` key} for every
    conv and BatchNorm tensor of ``model``'s backbone: ``conv1``/``bn1`` ->
    ``stem_conv``/``stem_bn``, ``layerN.B.convC``/``bnC`` ->
    ``stageN_blockB.convC``/``bnC``, ``downsample.0``/``.1`` ->
    ``downsample_conv``/``downsample_bn``."""
    keys = {"conv1.weight": "backbone.stem_conv.weight"}

    def bn(tv, port):
        keys.update({f"{tv}.{t}": f"backbone.{port}.{t}" for t in _BN_TENSORS})

    bn("bn1", "stem_bn")
    backbone = model.backbone
    for s, n in enumerate(backbone.stage_sizes, start=1):
        for b in range(n):
            tv, port = f"layer{s}.{b}", f"stage{s}_block{b}"
            for c in (1, 2, 3):
                keys[f"{tv}.conv{c}.weight"] = f"backbone.{port}.conv{c}.weight"
                bn(f"{tv}.bn{c}", f"{port}.bn{c}")
            if getattr(backbone, port).downsample_conv is not None:
                keys[f"{tv}.downsample.0.weight"] = f"backbone.{port}.downsample_conv.weight"
                bn(f"{tv}.downsample.1", f"{port}.downsample_bn")
    return keys


def load_torch_resnet_weights(model: DeepLabV3Plus, state_dict_path: str) -> List[str]:
    """Copy a torchvision ResNet ``state_dict`` (a local ``.pth``) onto
    ``model``'s backbone: conv weights, BatchNorm weight/bias and running
    mean/variance (without the running statistics a pretrained backbone
    gives wrong eval-mode activations). ``fc.*`` and ``num_batches_tracked``
    are ignored, as the JAX loader ignores them; a backbone tensor the file
    lacks keeps its value. A key with no place in the backbone (a deeper
    ResNet than the model) or a tensor of another shape raises. Returns
    the port keys written."""
    sd = torch.load(state_dict_path, map_location="cpu", weights_only=True)
    keys = torchvision_keys(model)
    state = model.state_dict()
    new = {}
    for key, value in sd.items():
        if key.startswith("fc.") or key.endswith("num_batches_tracked"):
            continue
        if key not in keys:
            raise KeyError(f"{state_dict_path}: {key} has no place in the backbone")
        target = keys[key]
        if tuple(value.shape) != tuple(state[target].shape):
            raise ValueError(f"{key}: shape {tuple(value.shape)} for {target} of "
                             f"{tuple(state[target].shape)}")
        new[target] = value
    with torch.no_grad():
        for target, value in new.items():
            state[target].copy_(value)
    return sorted(new)


def export_torch_resnet_weights(model: DeepLabV3Plus, path: str) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`load_torch_resnet_weights`: write ``model``'s
    backbone as a torchvision-layout ResNet ``state_dict`` (float32, with
    the ``num_batches_tracked`` zeros torchvision files carry) to ``path``;
    returns it."""
    state = model.state_dict()
    sd = {}
    for tv, port in torchvision_keys(model).items():
        sd[tv] = state[port].detach().float().cpu().clone()
        if tv.endswith(".running_var"):
            sd[tv[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(
                0, dtype=torch.long)
    torch.save(sd, path)
    return sd

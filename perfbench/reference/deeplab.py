"""Plain reference of DeepLab v3+ on a ResNet backbone (the parking model).

DeepLab v3+ (Chen et al. 2018, arXiv:1802.02611) as the configuration
file states it:

- ResNet bottleneck backbone (``stage_sizes``; 3, 4, 6, 3 is ResNet-50):
  a 7x7 stride-2 stem conv -> BatchNorm -> ReLU -> 3x3 stride-2 max-pool,
  then per stage bottlenecks 1x1 -> 3x3 -> 1x1 (x4 channels), each conv
  followed by BatchNorm, the shortcut a strided 1x1 conv -> BatchNorm
  where channels or stride change. Output stride 16: the last stage keeps
  stride 1 and dilates its 3x3 convs by 2. Backbone convs have no bias;
  its BatchNorms use ``backbone_bn_eps``.
- ASPP over the last stage: a 1x1 branch, 3x3 branches dilated by
  ``aspp_rates``, an image-pooling branch (global mean -> 1x1, broadcast
  back), concatenated and fused by a 1x1; each conv has a bias and is
  followed by BatchNorm (``aspp_bn_eps``) and ReLU.
- Decoder: the ASPP output resized bilinearly (half-pixel centres) to the
  stride-4 features, concatenated with a 48-channel 1x1 projection of them
  (-> BatchNorm -> ReLU), two 3x3 conv -> BatchNorm -> ReLU of 256, a 1x1
  head with a bias, resized bilinearly to the input.

Padding is TensorFlow's "SAME": for a strided window the total padding
is ``max((ceil(n/s) - 1)*s + (k - 1)*d + 1 - n, 0)``, the smaller half
before; the max-pool pads with -inf.

Inputs and outputs are NHWC float32; parameters a dict named as the
program's ``state_dict`` names them (:func:`specs`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.layers import Ops, batch_norm, bn_spec, conv_spec

# (width, stride, dilation) of the four stages at output stride 16
PLAN = ((64, 1, 1), (128, 2, 1), (256, 2, 1), (512, 1, 2))
LOW_CH = 48
DECODER_CH = 256


def specs(model: dict):
    out = []
    cin = model["in_channels"]
    out += conv_spec("backbone.stem_conv", 64, cin, 7, bias=False)
    out += bn_spec("backbone.stem_bn", 64)
    ch = 64
    for s, ((feat, stride, _), n) in enumerate(zip(PLAN, model["stage_sizes"]), start=1):
        for b in range(n):
            blk = f"backbone.stage{s}_block{b}"
            out += conv_spec(f"{blk}.conv1", feat, ch, 1, bias=False)
            out += bn_spec(f"{blk}.bn1", feat)
            out += conv_spec(f"{blk}.conv2", feat, feat, 3, bias=False)
            out += bn_spec(f"{blk}.bn2", feat)
            out += conv_spec(f"{blk}.conv3", feat * 4, feat, 1, bias=False)
            out += bn_spec(f"{blk}.bn3", feat * 4, residual=True)
            if ch != feat * 4 or (b == 0 and stride != 1):
                out += conv_spec(f"{blk}.downsample_conv", feat * 4, ch, 1, bias=False)
                out += bn_spec(f"{blk}.downsample_bn", feat * 4)
            ch = feat * 4
    a = model["aspp_features"]
    n_rates = len(model["aspp_rates"])
    for i in range(n_rates + 2):
        out += conv_spec(f"aspp.ConvBNAct_{i}.Conv_0", a, ch, 3 if 1 <= i <= n_rates else 1)
        out += bn_spec(f"aspp.ConvBNAct_{i}.BatchNorm_0", a)
    out += conv_spec(f"aspp.ConvBNAct_{n_rates + 2}.Conv_0", a, a * (n_rates + 2), 1)
    out += bn_spec(f"aspp.ConvBNAct_{n_rates + 2}.BatchNorm_0", a)
    out += conv_spec("low_proj", LOW_CH, PLAN[0][0] * 4, 1, bias=False)
    out += bn_spec("low_bn", LOW_CH)
    ch = a + LOW_CH
    for i in range(2):
        out += conv_spec(f"decoder_conv{i}", DECODER_CH, ch, 3, bias=False)
        out += bn_spec(f"decoder_bn{i}", DECODER_CH)
        ch = DECODER_CH
    out += conv_spec("head", model["n_classes"], ch, 1)
    return out


def _same(n: int, k: int, s: int, d: int):
    total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, k, s, d=1, value=0.0):
    top, bottom = _same(x.shape[2], k, s, d)
    left, right = _same(x.shape[3], k, s, d)
    return F.pad(x, (left, right, top, bottom), value=value)


def logits(p: dict, x: torch.Tensor, model: dict, ops: Ops, bn: str = "eval"):
    """(B, H, W, C) float32 -> (B, H, W, n_classes) float32 logits."""
    beps, aeps = model["backbone_bn_eps"], model["aspp_bn_eps"]

    def conv(x, name, k, stride=1, dilation=1, bias=False):
        w, b = p[f"{name}.weight"], p[f"{name}.bias"] if bias else None
        if stride == 1:
            return ops.conv(x, w, b, padding=dilation * (k - 1) // 2, dilation=dilation)
        return ops.conv(_pad_same(x, k, stride, dilation), w, b, stride=stride,
                        dilation=dilation)

    def norm(x, name, eps=beps):
        return batch_norm(x, p, name, eps, bn)

    in_hw = x.shape[1:3]
    x = x.permute(0, 3, 1, 2)
    x = F.relu(norm(conv(x, "backbone.stem_conv", 7, 2), "backbone.stem_bn"))
    x = F.max_pool2d(_pad_same(x, 3, 2, value=float("-inf")), 3, 2)
    c2 = None
    for s, ((_, stride, dilation), n) in enumerate(zip(PLAN, model["stage_sizes"]), start=1):
        for b in range(n):
            blk = f"backbone.stage{s}_block{b}"
            st = stride if b == 0 else 1
            y = F.relu(norm(conv(x, f"{blk}.conv1", 1), f"{blk}.bn1"))
            y = F.relu(norm(conv(y, f"{blk}.conv2", 3, st, dilation), f"{blk}.bn2"))
            y = norm(conv(y, f"{blk}.conv3", 1), f"{blk}.bn3")
            if f"{blk}.downsample_conv.weight" in p:
                x = norm(conv(x, f"{blk}.downsample_conv", 1, st), f"{blk}.downsample_bn")
            x = F.relu(y + x)
        if s == 1:
            c2 = x
    rates = model["aspp_rates"]

    def aspp_branch(x, i, k, dilation=1):
        name = f"aspp.ConvBNAct_{i}"
        return F.relu(norm(conv(x, f"{name}.Conv_0", k, 1, dilation, bias=True),
                           f"{name}.BatchNorm_0", aeps))

    branches = [aspp_branch(x, 0, 1)]
    branches += [aspp_branch(x, i, 3, r) for i, r in enumerate(rates, start=1)]
    pooled = aspp_branch(x.mean(dim=(2, 3), keepdim=True), len(rates) + 1, 1)
    branches.append(pooled.expand(-1, -1, x.shape[2], x.shape[3]))
    y = aspp_branch(torch.cat(branches, dim=1), len(rates) + 2, 1)
    y = F.interpolate(y, size=tuple(c2.shape[2:]), mode="bilinear", align_corners=False)
    low = F.relu(norm(conv(c2, "low_proj", 1), "low_bn"))
    y = torch.cat([y, low], dim=1)
    for i in range(2):
        y = F.relu(norm(conv(y, f"decoder_conv{i}", 3), f"decoder_bn{i}"))
    y = conv(y, "head", 1, bias=True)
    y = F.interpolate(y, size=tuple(in_hw), mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)

"""Prithvi-EO-2.0: a ViT encoder over multi-date HLS stacks, with a
convolutional segmentation head.

The encoder is the MAE-pretrained ViT of Szwarcman et al.
(arXiv:2412.02732), as the model card of
``ibm-nasa-geospatial/Prithvi-EO-2.0-300M`` publishes it (the variant
without temporal and location embeddings; 300M is width 1024, depth 24,
16 heads, MLP 4096, patch 16):

- the input is a (B, H, W, frames * bands) NHWC stack, frame-major
  (channel ``t * bands + b``), standardised per band with ``mean`` and
  ``std`` (constructor arguments, so the checkpoint's ``model_kwargs``
  carry them), in float32 before the cast to the parameters' dtype;
- patch embedding: published as a Conv3d of kernel and stride (1, p, p)
  over (bands, frames, H, W), held here as the same linear map of each
  frame's p x p patches, ``encoder.patch_embed.proj`` of shape
  (width, bands * p * p) (the published weight flattened after its first
  axis). A Conv3d's 5-D weight refuses the channels-last format that
  serving casts a model to;
- tokens in (frame, row, column) order after a class token, plus the
  fixed 3-D sin-cos table of the grid the input gives (:func:`sincos_3d`;
  zero at the class token), so any side that is a multiple of ``p``
  serves;
- ``depth`` pre-norm blocks ``x += proj(attn(LN(x)))`` and
  ``x += fc2(GELU(fc1(LN(x))))``, qkv with bias, exact (erf) GELU,
  LayerNorm eps 1e-6, then a final LayerNorm. Attention is
  ``F.scaled_dot_product_attention``, no backend forced.

The head (the model card publishes the encoder only) drops the class
token, lays the last layer's tokens out as (B, frames * width, H/p, W/p),
the frames side by side along channels, and runs one stage per
``head_widths`` entry: a 2x2 stride-2 transposed conv and a 3x3
conv -> BatchNorm -> ReLU (``ConvBNAct``); ``2 ** len(head_widths)`` must
be ``p``. A 1x1 conv gives ``n_classes`` logits.

The output contract is ``UNet``'s: NHWC in, a dict of float32 NHWC
``logits`` and ``probs`` (sigmoid or softmax) and int32 ``classes`` out.

Spans (``utils.profiling.span``, recorded only under a profiler), one
each per forward: ``vit.embed``, ``vit.encoder`` (attributes ``chips``,
``tokens``, ``heads``, ``head_dim``, ``layers`` and the attention's
``dtype``) and ``vit.head``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from satellite_computervision_tpu_torch.models.blocks import BN_MOMENTUM, ConvBNAct
from satellite_computervision_tpu_torch.utils.profiling import span

LN_EPS = 1e-6


def sincos_1d(width: int, positions: torch.Tensor) -> torch.Tensor:
    """MAE's 1-D table: (len(positions), width) of
    ``[sin(pos * omega), cos(pos * omega)]``, ``omega_i = 10000**(-2i/width)``."""
    omega = 1.0 / 10000 ** (torch.arange(width // 2, dtype=torch.float64) / (width / 2.0))
    angle = positions.double()[:, None] * omega[None, :]
    return torch.cat([angle.sin(), angle.cos()], dim=1)


def sincos_3d(width: int, frames: int, rows: int, cols: int) -> torch.Tensor:
    """The fixed position table of ``1 + frames*rows*cols`` tokens, float32:
    zero for the class token, then each token's (column, row, frame)
    tables side by side, of widths 6/16, 6/16 and 4/16 of ``width``."""
    if width % 16:
        raise ValueError(f"the 3-D sin-cos table needs a width divisible by 16, not {width}")
    part = width // 16
    t, r, c = torch.meshgrid(torch.arange(frames), torch.arange(rows), torch.arange(cols),
                             indexing="ij")
    table = torch.cat([sincos_1d(6 * part, c.reshape(-1)), sincos_1d(6 * part, r.reshape(-1)),
                       sincos_1d(4 * part, t.reshape(-1))], dim=1)
    return torch.cat([torch.zeros(1, width, dtype=table.dtype), table]).float()


class Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        if width % heads:
            raise ValueError(f"width {width} is not a multiple of {heads} heads")
        self.heads = heads
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)

    def forward(self, x):
        b, n, d = x.shape
        q, k, v = self.qkv(x).view(b, n, 3, self.heads, d // self.heads).permute(2, 0, 3, 1, 4)
        x = F.scaled_dot_product_attention(q, k, v)
        return self.proj(x.transpose(1, 2).reshape(b, n, d))


class Mlp(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(width, hidden)
        self.fc2 = nn.Linear(hidden, width)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, width: int, heads: int, mlp: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(width, eps=LN_EPS)
        self.attn = Attention(width, heads)
        self.norm2 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp = Mlp(width, mlp)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, bands: int, patch: int, width: int):
        super().__init__()
        self.proj = nn.Linear(bands * patch * patch, width)


class Encoder(nn.Module):
    """Patch embedding, class token, position table and the blocks."""

    def __init__(self, bands: int, patch: int, width: int, depth: int, heads: int, mlp: int):
        super().__init__()
        self.bands, self.patch, self.width, self.heads = bands, patch, width, heads
        self.patch_embed = PatchEmbed(bands, patch, width)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, width))
        self.blocks = nn.ModuleList(Block(width, heads, mlp) for _ in range(depth))
        self.norm = nn.LayerNorm(width, eps=LN_EPS)
        self._tables: Dict[Tuple, torch.Tensor] = {}

    def positions(self, frames: int, rows: int, cols: int, like: torch.Tensor) -> torch.Tensor:
        key = (frames, rows, cols, like.device, like.dtype)
        if key not in self._tables:
            self._tables[key] = sincos_3d(self.width, frames, rows, cols).to(like)
        return self._tables[key]

    def embed(self, x: torch.Tensor, frames: int) -> torch.Tensor:
        """(B, H, W, frames * bands) standardised stack -> (B, 1 + N, width)."""
        b, h, w, _ = x.shape
        p = self.patch
        rows, cols = h // p, w // p
        patches = (x.reshape(b, rows, p, cols, p, frames, self.bands)
                   .permute(0, 5, 1, 3, 6, 2, 4)
                   .reshape(b, frames * rows * cols, self.bands * p * p))
        tokens = self.patch_embed.proj(patches)
        tokens = torch.cat([self.cls_token.expand(b, -1, -1), tokens], dim=1)
        return tokens + self.positions(frames, rows, cols, tokens)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            tokens = block(tokens)
        return self.norm(tokens)


class HeadStage(nn.Module):
    def __init__(self, in_ch: int, features: int, bn_momentum: float):
        super().__init__()
        self.up = nn.ConvTranspose2d(in_ch, features, 2, stride=2)
        self.conv = ConvBNAct(features, features, bn_momentum=bn_momentum)

    def forward(self, x):
        return self.conv(self.up(x))


class SegmentationHead(nn.Module):
    def __init__(self, in_ch: int, widths: Sequence[int], n_classes: int, bn_momentum: float):
        super().__init__()
        chans = [in_ch, *widths]
        self.stages = nn.ModuleList(HeadStage(a, b, bn_momentum) for a, b in zip(chans, widths))
        self.out = nn.Conv2d(chans[-1], n_classes, 1)

    def forward(self, x):
        for stage in self.stages:
            x = stage(x)
        return self.out(x)


class PrithviSegmenter(nn.Module):
    """The Prithvi-EO-2.0 encoder and a segmentation head (module doc).

    ``in_channels`` is the stack the engine sees, ``frames`` times the
    bands; the defaults are the 300M model's."""

    def __init__(
        self,
        in_channels: int,
        frames: int = 4,
        patch: int = 16,
        width: int = 1024,
        depth: int = 24,
        heads: int = 16,
        mlp: int = 4096,
        n_classes: int = 1,
        head: str = "sigmoid",
        threshold: float = 0.5,
        head_widths: Sequence[int] = (512, 256, 128, 64),
        mean: Optional[Sequence[float]] = None,
        std: Optional[Sequence[float]] = None,
        bn_momentum: float = BN_MOMENTUM,
    ):
        super().__init__()
        if in_channels % frames:
            raise ValueError(f"{in_channels} channels are not {frames} frames of equal bands")
        if head not in ("sigmoid", "softmax"):
            raise ValueError(f"unknown head {head!r}")
        if 2 ** len(head_widths) != patch:
            raise ValueError(f"{len(head_widths)} head stages do not upsample patches of {patch}")
        bands = in_channels // frames
        self.kwargs = dict(
            in_channels=in_channels, frames=frames, patch=patch, width=width, depth=depth,
            heads=heads, mlp=mlp, n_classes=n_classes, head=head, threshold=threshold,
            head_widths=tuple(head_widths), mean=None if mean is None else tuple(mean),
            std=None if std is None else tuple(std), bn_momentum=bn_momentum)
        for name, values in (("mean", mean), ("std", std)):
            if values is not None and len(values) != bands:
                raise ValueError(f"{name} has {len(values)} values for {bands} bands")
        self.frames, self.patch, self.head_kind, self.threshold = frames, patch, head, threshold
        self.encoder = Encoder(bands, patch, width, depth, heads, mlp)
        self.head = SegmentationHead(frames * width, head_widths, n_classes, bn_momentum)
        self._standard: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
        mae_init_(self)

    def _standardise(self, x: torch.Tensor) -> torch.Tensor:
        """(x - mean) / std per band, in float32 (the constants are not
        parameters, so a cast of the model leaves them exact)."""
        bands = self.encoder.bands
        if x.device not in self._standard:
            mean = self.kwargs["mean"] or (0.0,) * bands
            std = self.kwargs["std"] or (1.0,) * bands
            self._standard[x.device] = (torch.tensor(mean, dtype=torch.float32, device=x.device),
                                        torch.tensor(std, dtype=torch.float32, device=x.device))
        mean, std = self._standard[x.device]
        b, h, w, c = x.shape
        x = x.float().reshape(b, h, w, self.frames, bands)
        return ((x - mean) / std).reshape(b, h, w, c)

    def forward(self, x: torch.Tensor):
        """(B, H, W, frames * bands) -> dict of (B, H, W, n_classes)
        float32 outputs (``classes`` int32 (B, H, W) for softmax); H and W
        multiples of ``patch``."""
        b, h, w, _ = x.shape
        p, enc = self.patch, self.encoder
        if h % p or w % p:
            raise ValueError(f"a {h}x{w} input is not a whole number of {p}x{p} patches")
        rows, cols = h // p, w // p
        dtype = self.head.out.weight.dtype
        with span("vit.embed", chips=b):
            tokens = enc.embed(self._standardise(x).to(dtype), self.frames)
        with span("vit.encoder", chips=b, tokens=tokens.shape[1], heads=enc.heads,
                  head_dim=enc.width // enc.heads, layers=len(enc.blocks),
                  dtype=str(tokens.dtype).removeprefix("torch.")):
            tokens = enc(tokens)
        with span("vit.head", chips=b):
            grid = (tokens[:, 1:].reshape(b, self.frames, rows, cols, enc.width)
                    .permute(0, 2, 3, 1, 4).reshape(b, rows, cols, self.frames * enc.width))
            logits = self.head(grid.permute(0, 3, 1, 2)).float().permute(0, 2, 3, 1).contiguous()
        if self.head_kind == "softmax":
            probs = torch.softmax(logits, dim=-1)
            return {"logits": logits, "probs": probs,
                    "classes": torch.argmax(probs, dim=-1).to(torch.int32)}
        probs = torch.sigmoid(logits)
        return {"logits": logits, "probs": probs,
                "classes": (probs > self.threshold).to(torch.int32)}


def mae_init_(model: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Reset ``model``'s weights in place as MAE initialises its ViT: every
    linear map Xavier-uniform (the patch embedding's over its flattened
    patch), zero biases, LayerNorm 1 and 0, the class token N(0, 0.02^2);
    the head's convs and transposed convs He-uniform (PyTorch's default),
    BatchNorm 1 and 0 with fresh statistics."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                fan_out, fan_in = mod.weight.shape
                bound = math.sqrt(6.0 / (fan_in + fan_out))
                mod.weight.uniform_(-bound, bound, generator=generator)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.reset_parameters()
            elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                nn.init.kaiming_uniform_(mod.weight, a=math.sqrt(5), generator=generator)
                mod.bias.zero_()
            elif isinstance(mod, nn.BatchNorm2d):
                mod.reset_parameters()
            elif isinstance(mod, Encoder):
                mod.cls_token.normal_(0.0, 0.02, generator=generator)
    return model

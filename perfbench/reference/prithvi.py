"""Plain reference of Prithvi-EO-2.0 with a segmentation head.

The encoder of Szwarcman et al. (arXiv:2412.02732) as the model card of
``ibm-nasa-geospatial/Prithvi-EO-2.0-300M`` describes it, written out:

- the (B, H, W, frames * bands) frame-major stack is standardised per
  band with the configuration's ``mean`` and ``std``;
- each frame's p x p patches are embedded by a stride-p convolution, the
  published Conv3d of kernel (1, p, p) applied frame by frame; its weight
  is held as (width, bands * p * p), the program's layout, and viewed as
  (width, bands, p, p) here;
- tokens in (frame, row, column) order after a class token; the position
  table is the 3-D sin-cos formula, recomputed here: for each token the
  1-D MAE tables of its column, row and frame (widths 6/16, 6/16, 4/16 of
  the model's), ``[sin(pos*w_i), cos(pos*w_i)]`` with
  ``w_i = 10000**(-2i/d)``; zero at the class token;
- blocks ``x += proj(attn(LN(x)))``, ``x += fc2(gelu(fc1(LN(x))))`` with
  ``attn = softmax(q k^T / sqrt(head_dim)) v`` per head, erf GELU,
  LayerNorm eps 1e-6; a final LayerNorm.

Departures from the published model, each shared with the program:

- the head is assumed (the model card publishes the encoder only): the
  class token dropped, the frames' tokens side by side along channels,
  stages of [2x2 stride-2 transposed conv, 3x3 conv, BatchNorm, ReLU],
  a 1x1 conv to the logits;
- the standardisation constants are the configuration's, set to the
  synthetic imagery's range (the model card's are for HLS reflectance);
- weights are drawn from the seed, not the pretrained ones:
  :func:`specs` gives each linear map's ``weight`` a ``fan_in`` of its
  fan-in plus fan-out, so ``perfbench.inputs.draw_weights`` draws it with
  MAE's Xavier variance 2/(fan_in + fan_out) (normal, where MAE draws
  uniform); the class token N(0, 0.02^2) as MAE draws it (a ``fan_in`` of
  5000); biases N(0, 0.1^2) and LayerNorm scales 1 + N(0, 0.1^2) and
  shifts N(0, 0.1^2) where MAE starts them at 0 and 1.

Every linear map and convolution runs through ``Ops``, so the float8
control covers them; attention, LayerNorm and GELU stay float32. Inputs
and outputs are NHWC float32; parameters a dict named as the program's
``state_dict`` names them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.layers import Ops, batch_norm, bn_spec, conv_spec, conv_transpose_spec

LN_EPS = 1e-6
CLS_FAN_IN = 5000  # sqrt(2 / 5000) = 0.02, MAE's class-token std


def linear_spec(name: str, out_f: int, in_f: int):
    return [(f"{name}.weight", (out_f, in_f), "weight", in_f + out_f),
            (f"{name}.bias", (out_f,), "bias", 0)]


def ln_spec(name: str, width: int):
    return [(f"{name}.weight", (width,), "bn_weight", 0), (f"{name}.bias", (width,), "bn_bias", 0)]


def specs(model: dict):
    """``(name, shape, kind, fan_in)`` of every tensor of the model."""
    d, p = model["width"], model["patch"]
    bands = model["in_channels"] // model["frames"]
    out = linear_spec("encoder.patch_embed.proj", d, bands * p * p)
    out.append(("encoder.cls_token", (1, 1, d), "weight", CLS_FAN_IN))
    for i in range(model["depth"]):
        b = f"encoder.blocks.{i}"
        out += ln_spec(f"{b}.norm1", d) + linear_spec(f"{b}.attn.qkv", 3 * d, d)
        out += linear_spec(f"{b}.attn.proj", d, d) + ln_spec(f"{b}.norm2", d)
        out += linear_spec(f"{b}.mlp.fc1", model["mlp"], d)
        out += linear_spec(f"{b}.mlp.fc2", d, model["mlp"])
    out += ln_spec("encoder.norm", d)
    ch = model["frames"] * d
    for i, feat in enumerate(model["head_widths"]):
        s = f"head.stages.{i}"
        out += conv_transpose_spec(f"{s}.up", ch, feat, 2)
        out += conv_spec(f"{s}.conv.Conv_0", feat, feat, 3) + bn_spec(f"{s}.conv.BatchNorm_0", feat)
        ch = feat
    return out + conv_spec("head.out", model["n_classes"], ch, 1)


def sincos(width: int, positions: torch.Tensor) -> torch.Tensor:
    i = torch.arange(width // 2, dtype=torch.float64, device=positions.device)
    angle = positions.double()[:, None] * 10000.0 ** (-2.0 * i / width)[None, :]
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=1)


def position_table(width: int, frames: int, rows: int, cols: int, device) -> torch.Tensor:
    """(1 + frames*rows*cols, width) float32, tokens in (frame, row,
    column) order."""
    idx = torch.arange(frames * rows * cols, device=device)
    t, r, c = idx // (rows * cols), (idx // cols) % rows, idx % cols
    part = width // 16
    table = torch.cat([sincos(6 * part, c), sincos(6 * part, r), sincos(4 * part, t)], dim=1)
    return torch.cat([torch.zeros(1, width, dtype=table.dtype, device=device), table]).float()


def linear(ops: Ops, x, w, b):
    """``x @ w.T + b`` through ``ops`` (in float8 for the control)."""
    return ops._run(F.linear, x, w, b)


def layer_norm(x, p, prefix):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * p[f"{prefix}.weight"] + p[f"{prefix}.bias"]


def attention(x, p, prefix, heads: int, ops: Ops):
    b, n, d = x.shape
    hd = d // heads
    qkv = linear(ops, x, p[f"{prefix}.qkv.weight"], p[f"{prefix}.qkv.bias"])
    q, k, v = qkv.view(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    weights = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
    out = (weights @ v).transpose(1, 2).reshape(b, n, d)
    return linear(ops, out, p[f"{prefix}.proj.weight"], p[f"{prefix}.proj.bias"])


def block(tokens, p, prefix: str, heads: int, ops: Ops):
    """One pre-norm block of the encoder."""
    tokens = tokens + attention(layer_norm(tokens, p, f"{prefix}.norm1"), p, f"{prefix}.attn",
                                heads, ops)
    hidden = F.gelu(linear(ops, layer_norm(tokens, p, f"{prefix}.norm2"),
                           p[f"{prefix}.mlp.fc1.weight"], p[f"{prefix}.mlp.fc1.bias"]))
    return tokens + linear(ops, hidden, p[f"{prefix}.mlp.fc2.weight"], p[f"{prefix}.mlp.fc2.bias"])


def encode(p: dict, x: torch.Tensor, model: dict, ops: Ops) -> torch.Tensor:
    """(B, H, W, frames * bands) float32 -> the encoder's (B, 1 + N, width)
    tokens after its final LayerNorm."""
    b, h, w, c = x.shape
    frames, patch, d = model["frames"], model["patch"], model["width"]
    bands = c // frames
    rows, cols = h // patch, w // patch
    mean = torch.tensor(model["mean"], dtype=torch.float32, device=x.device)
    std = torch.tensor(model["std"], dtype=torch.float32, device=x.device)
    x = (x.reshape(b, h, w, frames, bands) - mean) / std
    # each frame through the patch embedding: (B*frames, bands, H, W)
    frames_first = x.permute(0, 3, 4, 1, 2).reshape(b * frames, bands, h, w)
    kernel = p["encoder.patch_embed.proj.weight"].view(d, bands, patch, patch)
    emb = ops.conv(frames_first, kernel, p["encoder.patch_embed.proj.bias"], stride=patch)
    tokens = emb.reshape(b, frames, d, rows * cols).permute(0, 1, 3, 2).reshape(b, -1, d)
    tokens = torch.cat([p["encoder.cls_token"].expand(b, 1, d), tokens], dim=1)
    tokens = tokens + position_table(d, frames, rows, cols, x.device)
    for i in range(model["depth"]):
        tokens = block(tokens, p, f"encoder.blocks.{i}", model["heads"], ops)
    return layer_norm(tokens, p, "encoder.norm")


def logits(p: dict, x: torch.Tensor, model: dict, ops: Ops, bn: str = "eval"):
    """(B, H, W, frames * bands) float32 -> (B, H, W, n_classes) float32
    logits."""
    b, h, w, _ = x.shape
    frames, d = model["frames"], model["width"]
    rows, cols = h // model["patch"], w // model["patch"]
    tokens = encode(p, x, model, ops)
    # the frames' tokens side by side along channels: channel t*d + e
    y = tokens[:, 1:].reshape(b, frames, rows, cols, d).permute(0, 1, 4, 2, 3)
    y = y.reshape(b, frames * d, rows, cols)
    for i in range(len(model["head_widths"])):
        s = f"head.stages.{i}"
        y = ops.conv_transpose(y, p[f"{s}.up.weight"], p[f"{s}.up.bias"], 2)
        y = ops.conv(y, p[f"{s}.conv.Conv_0.weight"], p[f"{s}.conv.Conv_0.bias"], padding=1)
        y = F.relu(batch_norm(y, p, f"{s}.conv.BatchNorm_0", model["bn_eps"], bn))
    y = ops.conv(y, p["head.out.weight"], p["head.out.bias"])
    return y.permute(0, 2, 3, 1)

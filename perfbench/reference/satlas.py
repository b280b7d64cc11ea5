"""Plain reference of SatlasPretrain's multi-image Sentinel-2 Swin-v2-Base
with its FPN and segmentation head.

The model of Bastani et al. (arXiv:2211.15660) as
``allenai/satlaspretrain_models`` builds ``Sentinel2_SwinB_MI_MS`` on
torchvision's ``swin_v2_b``, written out:

- the (B, H, W, frames * bands) frame-major stack: each band divided by
  the configuration's ``scale`` and clipped to [0, 1];
- each date through the backbone on its own (Satlas's aggregation
  backbone loops over the dates): a stride-``patch`` conv, a LayerNorm,
  then four stages. A stage after the first opens with PatchMergingV2:
  the map padded with zeros to even sides, each 2 x 2 neighbourhood's
  four tokens concatenated in the order (0, 0), (1, 0), (0, 1), (1, 1)
  (row, column offsets), a bias-free linear map to twice the width and a
  LayerNorm. Blocks are res-post-norm, ``x += LN(attn(x))``,
  ``x += LN(fc2(gelu(fc1(x))))``, LayerNorm eps 1e-5;
- attention: the map padded with zeros to a multiple of the window
  (padded tokens take part unmasked); in odd blocks rolled by minus half
  a window along each side the padded map has more than one window of;
  cut into windows; per head, logits ``tau * cos(q, k) + B + M`` with
  ``tau = exp(min(logit_scale, ln 100))``, the k third of the qkv bias
  left out, ``B`` the continuous position bias computed here for each
  pair of tokens from its offset (dy, dx): ``u = 8 * d / (window - 1)``,
  ``sign(u) * log2(|u| + 1) / 3`` per axis, through the MLP 2 -> 512 ->
  heads (ReLU, no bias on the second map), ``16 * sigmoid``; ``M`` is -100
  between tokens that lie in different regions of the rolled map (each
  axis cut at ``pad - window`` and ``pad - shift``) and 0 otherwise;
  softmax, times v, the heads joined, the output map, rolled back,
  cropped;
- each stage's output, the element-wise max over the dates;
- the feature pyramid: a 1 x 1 conv per level, from the coarsest level
  down each lateral plus the level above repeated to its size (nearest:
  source index ``floor(i * in / out)``), a 3 x 3 conv on the finest;
- the head: per x2 step a 3 x 3 conv, ReLU, a 4 x 4 stride-2 transposed
  conv with padding 1 (here: without padding, then one pixel cropped
  from every side, which is the same map), ReLU; then a 3 x 3 conv, ReLU,
  a 3 x 3 conv to the logits.

Departures from the published model, each shared with the program:

- the nine bands are all scaled by a divisor and clipped (the published
  Sentinel-2 code takes B04, B03 and B02 as an 8-bit TCI over 255; the
  synthetic scene has none);
- one logit under a sigmoid for the binary map, where Satlas's
  segmentation head gives two under a softmax (the same probabilities);
- the FPN's outputs at strides 8 to 32 feed nothing in this head and are
  not computed;
- weights are drawn from the seed, not the pretrained ones
  (:func:`specs`): linear maps normal with the Xavier variance
  2 / (fan_in + fan_out); ``logit_scale`` is drawn as a scale,
  1 + N(0, 0.1^2), where Swin-v2 starts it at log 10, so tau is near 2.7
  where it starts at 10 (``draw_weights`` has no kind for log 10); the
  position-bias MLP's second map has a variance of 2 / :data:`CPB_FAN_IN`,
  so that the bias spreads over about as many logits as the cosine term
  (neither swamps the other); convs that no ReLU follows (the FPN's) have
  the variance 1 / fan_in, which keeps their output's scale, and the last
  conv 2 / :data:`LOGIT_FAN_IN`, which puts the logits at a scale of a few
  units, so the probabilities spread over (0, 1).

Every linear map and convolution runs through ``Ops``, so the float8
control covers them; attention, LayerNorm and GELU stay float32. Inputs
and outputs are NHWC float32; parameters a dict named as the program's
``state_dict`` names them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.layers import Ops, conv_spec

LN_EPS = 1e-5
CPB_HIDDEN = 512
# the fan-in behind the position-bias MLP's second map and the last
# conv (module doc)
CPB_FAN_IN = 200000
LOGIT_FAN_IN = 20000


def linear_spec(name: str, out_f: int, in_f: int, bias: bool = True):
    out = [(f"{name}.weight", (out_f, in_f), "weight", in_f + out_f)]
    return out + ([(f"{name}.bias", (out_f,), "bias", 0)] if bias else [])


def ln_spec(name: str, width: int):
    return [(f"{name}.weight", (width,), "bn_weight", 0), (f"{name}.bias", (width,), "bn_bias", 0)]


def _widths(model: dict):
    return [model["embed"] * 2 ** i for i in range(len(model["depths"]))]


def specs(model: dict):
    """``(name, shape, kind, fan_in)`` of every tensor of the model."""
    p, bands = model["patch"], model["bands"]
    out = [("backbone.patch_embed.weight", (model["embed"], bands, p, p), "weight",
            bands * p * p), ("backbone.patch_embed.bias", (model["embed"],), "bias", 0)]
    out += ln_spec("backbone.norm", model["embed"])
    for i, (dim, depth, heads) in enumerate(zip(_widths(model), model["depths"], model["heads"])):
        s = f"backbone.stages.{i}"
        if i:
            out += linear_spec(f"{s}.downsample.reduction", dim, 2 * dim, bias=False)
            out += ln_spec(f"{s}.downsample.norm", dim)
        for j in range(depth):
            b = f"{s}.blocks.{j}"
            out += linear_spec(f"{b}.attn.qkv", 3 * dim, dim)
            out += linear_spec(f"{b}.attn.proj", dim, dim)
            out.append((f"{b}.attn.logit_scale", (heads, 1, 1), "bn_weight", 0))
            out.append((f"{b}.attn.cpb_mlp.0.weight", (CPB_HIDDEN, 2), "weight", 2))
            out.append((f"{b}.attn.cpb_mlp.0.bias", (CPB_HIDDEN,), "bias", 0))
            out.append((f"{b}.attn.cpb_mlp.2.weight", (heads, CPB_HIDDEN), "weight", CPB_FAN_IN))
            out += ln_spec(f"{b}.norm1", dim)
            hidden = model["mlp_ratio"] * dim
            out += linear_spec(f"{b}.mlp.fc1", hidden, dim)
            out += linear_spec(f"{b}.mlp.fc2", dim, hidden)
            out += ln_spec(f"{b}.norm2", dim)
    fpn = model["fpn"]
    for i, dim in enumerate(_widths(model)):
        out.append((f"fpn.inner_blocks.{i}.weight", (fpn, dim, 1, 1), "weight", 2 * dim))
        out.append((f"fpn.inner_blocks.{i}.bias", (fpn,), "bias", 0))
    out.append(("fpn.layer_block.weight", (fpn, fpn, 3, 3), "weight", 2 * fpn * 9))
    out.append(("fpn.layer_block.bias", (fpn,), "bias", 0))
    ch = fpn
    for i, width in enumerate(model["upsample_widths"]):
        out += conv_spec(f"upsample.{i}.conv", ch, ch, 3)
        out += [(f"upsample.{i}.up.weight", (ch, width, 4, 4), "weight", ch * 4),
                (f"upsample.{i}.up.bias", (width,), "bias", 0)]
        ch = width
    out += conv_spec("head.conv", model["head_width"], ch, 3)
    out.append(("head.out.weight", (model["n_classes"], model["head_width"], 3, 3), "weight",
                LOGIT_FAN_IN))
    out.append(("head.out.bias", (model["n_classes"],), "bias", 0))
    return out


def linear(ops: Ops, x, w, b=None):
    """``x @ w.T + b`` through ``ops`` (in float8 for the control)."""
    return ops._run(F.linear, x, w, b)


def layer_norm(x, p, prefix):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * p[f"{prefix}.weight"] + p[f"{prefix}.bias"]


def log_offsets(window: int, device) -> torch.Tensor:
    """(w^2, w^2, 2): for tokens i, j of a window (row-major), the
    log-spaced offset of i from j."""
    idx = torch.arange(window * window, device=device)
    y, x = idx // window, idx % window
    d = torch.stack([y[:, None] - y[None, :], x[:, None] - x[None, :]], dim=-1).double()
    u = 8.0 * d / (window - 1)
    return (torch.sign(u) * torch.log2(u.abs() + 1.0) / 3.0).float()


def position_bias(p, prefix: str, window: int) -> torch.Tensor:
    """(heads, w^2, w^2): ``16 * sigmoid(cpb_mlp(offset))`` for each pair."""
    table = log_offsets(window, p[f"{prefix}.cpb_mlp.0.weight"].device)
    hidden = torch.relu(table @ p[f"{prefix}.cpb_mlp.0.weight"].T + p[f"{prefix}.cpb_mlp.0.bias"])
    return 16.0 * torch.sigmoid(hidden @ p[f"{prefix}.cpb_mlp.2.weight"].T).permute(2, 0, 1)


def region_labels(pad: int, window: int, shift: int, device) -> torch.Tensor:
    """Each coordinate's region along one axis of the rolled map: 0 before
    ``pad - window``, 1 before ``pad - shift``, 2 after (one region when
    there is no roll)."""
    i = torch.arange(pad, device=device)
    if shift == 0:
        return torch.zeros_like(i)
    return (i >= pad - window).long() + (i >= pad - shift).long()


def to_windows(x, window: int):
    """(N, H, W, C) -> (N, windows, w^2, C), windows and their tokens
    row-major."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // window, window, w // window, window, c).transpose(2, 3)
    return x.reshape(n, -1, window * window, c)


def from_windows(x, h: int, w: int, window: int):
    n, _, _, c = x.shape
    x = x.reshape(n, h // window, w // window, window, window, c).transpose(2, 3)
    return x.reshape(n, h, w, c)


def attention(x, p, prefix: str, heads: int, window: int, shifted: bool, ops: Ops):
    """One block's shifted-window cosine attention of a (N, H, W, C) map."""
    n, h, w, c = x.shape
    d = c // heads
    pad_h, pad_w = math.ceil(h / window) * window, math.ceil(w / window) * window
    sh = window // 2 if shifted and pad_h > window else 0
    sw = window // 2 if shifted and pad_w > window else 0
    x = F.pad(x, (0, 0, 0, pad_w - w, 0, pad_h - h))
    x = torch.roll(x, shifts=(-sh, -sw), dims=(1, 2))
    tokens = to_windows(x, window)  # (N, nW, L, C)
    bias = p[f"{prefix}.qkv.bias"].clone()
    bias[c:2 * c] = 0.0
    qkv = linear(ops, tokens, p[f"{prefix}.qkv.weight"], bias)
    q, k, v = (qkv[..., i * c:(i + 1) * c].unflatten(-1, (heads, d)).transpose(2, 3)
               for i in range(3))  # (N, nW, heads, L, d)
    cos = (q / q.norm(dim=-1, keepdim=True).clamp(min=1e-12)) @ \
        (k / k.norm(dim=-1, keepdim=True).clamp(min=1e-12)).transpose(-1, -2)
    tau = torch.exp(torch.clamp(p[f"{prefix}.logit_scale"], max=math.log(100.0)))
    logits = tau * cos + position_bias(p, prefix, window)
    if sh or sw:
        lab = (region_labels(pad_h, window, sh, x.device)[:, None] * 3
               + region_labels(pad_w, window, sw, x.device)[None, :])
        lab = to_windows(lab[None, :, :, None], window)[0, :, :, 0]  # (nW, L)
        logits = logits + torch.where(lab[:, :, None] != lab[:, None, :], -100.0, 0.0)[:, None]
    out = torch.softmax(logits, dim=-1) @ v  # (N, nW, heads, L, d)
    out = linear(ops, out.transpose(2, 3).flatten(-2), p[f"{prefix}.proj.weight"],
                 p[f"{prefix}.proj.bias"])
    out = torch.roll(from_windows(out, pad_h, pad_w, window), shifts=(sh, sw), dims=(1, 2))
    return out[:, :h, :w]


def block(x, p, prefix: str, heads: int, window: int, shifted: bool, ops: Ops):
    x = x + layer_norm(attention(x, p, f"{prefix}.attn", heads, window, shifted, ops), p,
                       f"{prefix}.norm1")
    hidden = F.gelu(linear(ops, x, p[f"{prefix}.mlp.fc1.weight"], p[f"{prefix}.mlp.fc1.bias"]))
    return x + layer_norm(linear(ops, hidden, p[f"{prefix}.mlp.fc2.weight"],
                                 p[f"{prefix}.mlp.fc2.bias"]), p, f"{prefix}.norm2")


def merge(x, p, prefix: str, ops: Ops):
    n, h, w, c = x.shape
    x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    h2, w2 = x.shape[1] // 2, x.shape[2] // 2
    # (N, h2, row offset, w2, column offset, C) -> column offset major
    x = x.reshape(n, h2, 2, w2, 2, c).permute(0, 1, 3, 4, 2, 5).reshape(n, h2, w2, 4 * c)
    return layer_norm(linear(ops, x, p[f"{prefix}.reduction.weight"]), p, f"{prefix}.norm")


def backbone(p: dict, x: torch.Tensor, model: dict, ops: Ops):
    """(N, bands, H, W) scaled images -> the four stages' (N, h, w, C) maps."""
    y = ops.conv(x, p["backbone.patch_embed.weight"], p["backbone.patch_embed.bias"],
                 stride=model["patch"])
    y = layer_norm(y.permute(0, 2, 3, 1), p, "backbone.norm")
    feats = []
    for i, (depth, heads) in enumerate(zip(model["depths"], model["heads"])):
        s = f"backbone.stages.{i}"
        if i:
            y = merge(y, p, f"{s}.downsample", ops)
        for j in range(depth):
            y = block(y, p, f"{s}.blocks.{j}", heads, model["window"], j % 2 == 1, ops)
        feats.append(y)
    return feats


def nearest(x, size):
    """(N, C, h, w) repeated to ``size`` by nearest source pixel."""
    rows = torch.arange(size[0], device=x.device) * x.shape[2] // size[0]
    cols = torch.arange(size[1], device=x.device) * x.shape[3] // size[1]
    return x[:, :, rows][:, :, :, cols]


def logits(p: dict, x: torch.Tensor, model: dict, ops: Ops, bn: str = "eval"):
    """(B, H, W, frames * bands) float32 -> (B, H, W, n_classes) float32
    logits. ``bn`` is taken for the families' shared signature: the model
    has no BatchNorm."""
    b, h, w, _ = x.shape
    frames, bands = model["frames"], model["bands"]
    scale = torch.tensor(model["scale"], dtype=torch.float32, device=x.device)
    x = (x.reshape(b, h, w, frames, bands) / scale).clamp(0.0, 1.0)
    dates = [backbone(p, x[:, :, :, t].permute(0, 3, 1, 2), model, ops) for t in range(frames)]
    feats = [torch.stack([f[i] for f in dates]).amax(dim=0).permute(0, 3, 1, 2)
             for i in range(len(model["depths"]))]
    y = None
    for i in range(len(feats) - 1, -1, -1):
        lateral = ops.conv(feats[i], p[f"fpn.inner_blocks.{i}.weight"],
                           p[f"fpn.inner_blocks.{i}.bias"])
        y = lateral if y is None else lateral + nearest(y, lateral.shape[2:])
    y = ops.conv(y, p["fpn.layer_block.weight"], p["fpn.layer_block.bias"], padding=1)
    for i in range(len(model["upsample_widths"])):
        s = f"upsample.{i}"
        y = torch.relu(ops.conv(y, p[f"{s}.conv.weight"], p[f"{s}.conv.bias"], padding=1))
        y = ops.conv_transpose(y, p[f"{s}.up.weight"], p[f"{s}.up.bias"], 2)[:, :, 1:-1, 1:-1]
        y = torch.relu(y)
    y = torch.relu(ops.conv(y, p["head.conv.weight"], p["head.conv.bias"], padding=1))
    y = ops.conv(y, p["head.out.weight"], p["head.out.bias"], padding=1)
    return y.permute(0, 2, 3, 1)

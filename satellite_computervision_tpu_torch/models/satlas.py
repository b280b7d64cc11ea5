"""SatlasPretrain's multi-image Sentinel-2 Swin-v2-Base with its FPN and
segmentation head.

The model of Bastani et al., "SatlasPretrain" (ICCV 2023,
arXiv:2211.15660), as ``allenai/satlaspretrain_models`` builds
``Sentinel2_SwinB_MI_MS`` on torchvision's ``swin_v2_b``:

- the input is a (B, H, W, frames * bands) NHWC stack, frame-major
  (channel ``t * bands + b``); each band is divided by its ``scale`` and
  clipped to [0, 1] in float32 before the cast to the parameters' dtype;
- the backbone runs on every date: the B * frames images are one batch.
  Patch embedding is a stride-``patch`` conv and a LayerNorm; four stages
  of res-post-norm blocks ``x += LN(attn(x))``, ``x += LN(mlp(x))`` (MLP
  C -> 4C -> C, erf GELU, LayerNorm eps 1e-5); stages 1-3 open with
  PatchMergingV2 (the 2 x 2 neighbours concatenated after padding to even
  sides, a bias-free linear map 4C -> 2C, a LayerNorm);
- attention runs on ``window`` x ``window`` windows of the map after it
  is padded with zeros to a multiple of the window (padded tokens are not
  masked); odd blocks first roll the map by half a window, except along a
  side the window covers whole, and mask pairs of tokens from different
  regions of the rolled map by -100. Cosine attention:
  ``softmax(tau_h * q^ k^T + B + M) v`` with q and k L2-normalised,
  ``tau_h = exp(min(logit_scale_h, ln 100))``; the k third of the qkv bias
  is ignored (torchvision zeroes it on every forward); ``B`` is
  ``16 * sigmoid(cpb_mlp(table))`` over the log-spaced table of relative
  offsets (:func:`relative_coords_table`);
- each stage's output (strides 4 to 32; no final norm) is reduced over the
  dates by an element-wise max;
- a feature pyramid (torchvision's ``FeaturePyramidNetwork`` at ``fpn``
  channels: 1 x 1 laterals, nearest-neighbour top-down adds, a 3 x 3
  output conv). Only its stride-4 output feeds the head, so only that one
  is computed and carries weights;
- Satlas's ``Upsample``: per x2 step [3 x 3 conv, ReLU, ConvTranspose2d k4
  s2 p1, ReLU] at ``upsample_widths``; then its ``SimpleHead`` for
  segmentation, [3 x 3 conv, ReLU] at ``head_width`` and a 3 x 3 conv to
  ``n_classes`` logits. A binary map is one logit under a sigmoid (a
  two-class softmax is the sigmoid of the logits' difference).

Attention is one ``F.scaled_dot_product_attention`` call a block over all
windows of all images, ``q`` scaled by ``tau`` and ``scale=1``, the bias
plus shift mask as its float ``attn_mask``, no backend forced. The mask
holds ``B - 8`` (a softmax is blind to a constant, and the smaller
values round finer in bfloat16). One gather rolls the map and cuts it
into windows, another puts it back. SDPA reads q, k and v in place, as
(images * windows, heads, w^2, d) views of the token-major rows; so the
mask of a rolled block holds one copy per window of every image, and
that of a block without a roll one copy broadcast. q and k are divided
by their norms (q times tau) in one pass. Without autograd the mask, the
scales and the zeroed k bias are computed once per map size and cached
until the block's parameters change.

Served on CUDA (no autograd, autocast, dispatch or function mode, no
capture running), the four stages of an input shape are captured as one
CUDA graph each, in one memory pool, on the third forward of that shape
(:class:`StageGraphs`), and replayed after: a chip batch then launches
some thirty kernels where it launched some five hundred. A graph is
dropped when a stage's parameters change, and the backbone keeps those of
at most :data:`MAX_GRAPHS` shapes; a capture that fails leaves that shape
eager.

The output contract is ``UNet``'s: NHWC in, a dict of float32 NHWC
``logits`` and ``probs`` (sigmoid or softmax) and int32 ``classes`` out.

Spans (``utils.profiling.span``, recorded only under a profiler), per
forward: ``swin.embed``; one ``swin.stage`` a stage (its patch merging and
blocks; attributes ``stage``, ``images``, ``windows`` an image,
``tokens`` a window, ``heads``, ``head_dim``, ``layers`` (one attention
call each), ``rolled`` (those of its blocks that roll the map), the
attention's ``dtype``, ``mask_bytes`` (the ``attn_mask`` of its calls as
passed, summed) and ``padded_tokens`` an image); ``satlas.aggregate``,
``satlas.fpn`` and ``satlas.head``.
"""

from __future__ import annotations

import functools
import math
import warnings
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from satellite_computervision_tpu_torch.models.blocks import conv_bias_relu_, epilogue_route
from satellite_computervision_tpu_torch.models.prithvi import Mlp
from satellite_computervision_tpu_torch.utils.cuda_graphs import after_failed_capture, no_mode_active
from satellite_computervision_tpu_torch.utils.profiling import span

LN_EPS = 1e-5
MASK_FILL = -100.0
LOGIT_MAX = math.log(100.0)
CPB_HIDDEN = 512
# subtracted from 16 * sigmoid(.) (its value at 0) in the attention mask
BIAS_CENTRE = 8.0
# F.normalize's floor on a norm (a padded token's k is 0)
NORM_EPS = 1e-12
# eager forwards of an input shape before its stages are captured
EAGER_CALLS = 2
# input shapes whose captured stages (or count of eager forwards) one
# backbone keeps, the least recently used dropped with its memory pool
MAX_GRAPHS = 4


@functools.lru_cache(maxsize=None)
def relative_coords_table(window: int) -> torch.Tensor:
    """((2w-1)^2, 2) float32: each relative offset (dy, dx) in
    [-(w-1), w-1]^2, row-major, mapped to ``sign(u) * log2(|u| + 1) / 3``
    with ``u = 8 * d / (w - 1)``."""
    d = torch.arange(-(window - 1), window, dtype=torch.float32)
    table = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1).reshape(-1, 2)
    table = table / (window - 1) * 8.0
    return torch.sign(table) * torch.log2(table.abs() + 1.0) / 3.0


@functools.lru_cache(maxsize=None)
def relative_position_index(window: int) -> torch.Tensor:
    """(w^2, w^2) int64: the table row of the offset from token j to token i
    of a window, tokens row-major."""
    yy, xx = torch.meshgrid(torch.arange(window), torch.arange(window), indexing="ij")
    coords = torch.stack([yy.reshape(-1), xx.reshape(-1)])
    rel = coords[:, :, None] - coords[:, None, :] + (window - 1)
    return rel[0] * (2 * window - 1) + rel[1]


def window_geometry(h: int, w: int, window: int) -> Tuple[int, int, int, int]:
    """``(pad_h, pad_w, shift_h, shift_w)`` of an h x w map: sides padded
    to a multiple of ``window``, and the roll of a shifted block along each
    (none where the window covers the padded side whole)."""
    pad_h, pad_w = -(-h // window) * window, -(-w // window) * window
    half = window // 2
    return pad_h, pad_w, (half if pad_h > window else 0), (half if pad_w > window else 0)


def shift_mask(pad_h: int, pad_w: int, window: int, shift_h: int, shift_w: int) -> torch.Tensor:
    """(windows, w^2, w^2) float32: 0 between tokens of one region of the
    rolled map, -100 between regions (torchvision's slices)."""
    label = torch.zeros(pad_h, pad_w)
    count = 0
    for hs in ((0, -window), (-window, -shift_h), (-shift_h, None)):
        for ws in ((0, -window), (-window, -shift_w), (-shift_w, None)):
            label[hs[0]:hs[1], ws[0]:ws[1]] = count
            count += 1
    label = (label.view(pad_h // window, window, pad_w // window, window)
             .permute(0, 2, 1, 3).reshape(-1, window * window))
    diff = label[:, None, :] - label[:, :, None]
    return torch.where(diff != 0, MASK_FILL, 0.0)


_ORDERS: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def window_order(pad_h: int, pad_w: int, window: int, shift_h: int, shift_w: int,
                 device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(order, inverse)``, int64 over the ``pad_h * pad_w`` tokens of a
    padded map: ``order[t]`` is the map position (row-major) of the t-th
    token of the map rolled by ``(-shift_h, -shift_w)`` and cut into
    windows (windows and their tokens row-major); ``inverse`` puts them
    back. One gather then does the roll and the partition."""
    key = (pad_h, pad_w, window, shift_h, shift_w, device)
    if key not in _ORDERS:
        rows, cols = pad_h // window, pad_w // window
        r, c, i, j = torch.meshgrid(torch.arange(rows), torch.arange(cols), torch.arange(window),
                                    torch.arange(window), indexing="ij")
        y = (r * window + i + shift_h) % pad_h
        x = (c * window + j + shift_w) % pad_w
        order = (y * pad_w + x).reshape(-1)
        inverse = torch.empty_like(order)
        inverse[order] = torch.arange(order.numel())
        _ORDERS[key] = (order.to(device), inverse.to(device))
    return _ORDERS[key]


def _versions(tensors) -> Tuple:
    """Each tensor's storage and in-place update count: a new tensor or an
    update changes it."""
    return tuple((t.data_ptr(), t._version) for t in tensors)


class WindowAttention(nn.Module):
    """torchvision's ``ShiftedWindowAttentionV2`` (module doc), applied to
    a (N, H, W, C) map."""

    def __init__(self, dim: int, heads: int, window: int, shifted: bool):
        super().__init__()
        if dim % heads:
            raise ValueError(f"width {dim} is not a multiple of {heads} heads")
        self.heads, self.window, self.shifted = heads, window, shifted
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.logit_scale = nn.Parameter(torch.full((heads, 1, 1), math.log(10.0)))
        self.cpb_mlp = nn.Sequential(nn.Linear(2, CPB_HIDDEN), nn.ReLU(inplace=True),
                                     nn.Linear(CPB_HIDDEN, heads, bias=False))
        self._cache: Dict[Tuple, Tuple] = {}

    def geometry(self, h: int, w: int) -> Tuple[int, int, int, int]:
        pad_h, pad_w, sh, sw = window_geometry(h, w, self.window)
        return (pad_h, pad_w, sh, sw) if self.shifted else (pad_h, pad_w, 0, 0)

    def position_bias(self) -> torch.Tensor:
        """(heads, w^2, w^2) ``16 * sigmoid(cpb_mlp(table))``, float32."""
        fc1, fc2 = self.cpb_mlp[0], self.cpb_mlp[2]
        dev = fc1.weight.device
        table = relative_coords_table(self.window).to(dev)
        index = relative_position_index(self.window).to(dev)
        n = self.window * self.window
        # in float32 whatever the parameters' dtype: ((2w-1)^2, heads)
        per_offset = F.linear(F.relu(F.linear(table, fc1.weight.float(), fc1.bias.float())),
                              fc2.weight.float())
        return 16.0 * torch.sigmoid(per_offset[index.reshape(-1)].view(n, n, -1).permute(2, 0, 1))

    def _cached(self, key, params, make):
        """``make()``; without autograd, kept under ``key`` until one of
        ``params`` changes (a new tensor, or an in-place update)."""
        if torch.is_grad_enabled() or params[0].is_meta:
            return make()
        key = (key, params[0].device, torch.is_inference_mode_enabled())
        stamp = _versions(params)
        hit = self._cache.get(key)
        if hit is None or hit[0] != stamp:
            hit = self._cache[key] = (stamp, make())
        return hit[1]

    def _mask_and_scale(self, geometry, images: int, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        pad_h, pad_w, sh, sw = geometry
        bias = self.position_bias() - BIAS_CENTRE
        if sh or sw:
            mask = shift_mask(pad_h, pad_w, self.window, sh, sw).to(bias.device)
            bias = (bias[None] + mask[:, None]).expand(images, -1, -1, -1, -1).flatten(0, 1)
        else:
            bias = bias[None]
        tau = torch.exp(torch.clamp(self.logit_scale.float(), max=LOGIT_MAX)).view(1, -1)
        return bias.to(dtype).contiguous(), torch.cat([tau, torch.ones_like(tau)])

    def mask_and_scale(self, geometry, images: int, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """The ``attn_mask`` in ``dtype``: (1, heads, w^2, w^2) where no
        roll is made, else (images * windows, heads, w^2, w^2), one per
        window of every image; and the (2, heads) float32 scales of q^ and
        k^ (tau and 1). Without autograd, computed once per map size and
        image count until the parameters change."""
        params = [self.logit_scale, *self.cpb_mlp.parameters()]
        return self._cached((geometry, images, dtype), params,
                            lambda: self._mask_and_scale(geometry, images, dtype))

    def rolls(self, h: int, w: int) -> bool:
        """Whether :meth:`forward` rolls an h x w map."""
        return any(self.geometry(h, w)[2:])

    def mask_bytes(self, h: int, w: int, images: int, dtype) -> int:
        """Bytes of the ``attn_mask`` :meth:`forward` passes for an h x w map."""
        pad_h, pad_w = self.geometry(h, w)[:2]
        copies = images * (pad_h // self.window) * (pad_w // self.window) if self.rolls(h, w) else 1
        return copies * self.heads * self.window ** 4 * torch.finfo(dtype).bits // 8

    def qkv_bias(self) -> Optional[torch.Tensor]:
        """qkv's bias with its k third zeroed."""
        bias = self.qkv.bias
        if bias is None:
            return None
        c = self.qkv.in_features
        return self._cached("qkv_bias", [bias], lambda: torch.cat(
            [bias[:c], torch.zeros_like(bias[c:2 * c]), bias[2 * c:]]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_img, h, w, c = x.shape
        win, heads, d = self.window, self.heads, c // self.heads
        geometry = pad_h, pad_w, sh, sw = self.geometry(h, w)
        if (pad_h, pad_w) != (h, w):
            x = F.pad(x, (0, 0, 0, pad_w - w, 0, pad_h - h))
        order, inverse = window_order(pad_h, pad_w, win, sh, sw, x.device)
        # rolled and cut into windows by one gather: (N * windows * w^2, C)
        tokens = x.reshape(n_img, pad_h * pad_w, c).index_select(1, order).view(-1, c)
        qkv = F.linear(tokens, self.qkv.weight, self.qkv_bias())
        mask, scale = self.mask_and_scale(geometry, n_img, qkv.dtype)
        # q and k over their norms (q times tau): the squares summed by a
        # matmul, which reads them faster than a reduction over 32 values
        qk = qkv.view(-1, 3, heads, d)[:, :2]
        square_norm = F.linear(qk.square().view(-1, d), qk.new_ones((1, d))).view(-1, 2, heads)
        factor = torch.rsqrt(square_norm.float().clamp_min(NORM_EPS ** 2)) * scale
        qk = qk * factor.to(qk.dtype)[..., None]
        # (images * windows, heads, w^2, d) views of the token-major rows
        windows, n = (pad_h // win) * (pad_w // win), win * win
        q, k, v = (t.view(n_img * windows, n, heads, d).transpose(1, 2)
                   for t in (qk[:, 0], qk[:, 1], qkv.view(-1, 3, heads, d)[:, 2]))
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0)
        out = self.proj(out.transpose(1, 2).reshape(-1, c))
        out = out.view(n_img, pad_h * pad_w, c).index_select(1, inverse)
        return out.view(n_img, pad_h, pad_w, c)[:, :h, :w]


class SwinBlockV2(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shifted: bool, mlp_ratio: int):
        super().__init__()
        self.attn = WindowAttention(dim, heads, window, shifted)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, mlp_ratio * dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x):
        x = x + self.norm1(self.attn(x))
        return x + self.norm2(self.mlp(x))


class PatchMergingV2(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(2 * dim, eps=LN_EPS)

    def forward(self, x):
        h, w = x.shape[1:3]
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        return self.norm(self.reduction(x))


class Stage(nn.Module):
    """PatchMergingV2 (all stages but the first), then ``depth`` blocks,
    shifted every other one."""

    def __init__(self, dim: int, depth: int, heads: int, window: int, mlp_ratio: int,
                 merge: bool):
        super().__init__()
        self.downsample = PatchMergingV2(dim // 2) if merge else None
        self.blocks = nn.ModuleList(SwinBlockV2(dim, heads, window, i % 2 == 1, mlp_ratio)
                                    for i in range(depth))

    def attrs(self, h: int, w: int, images: int, dtype: torch.dtype) -> Dict:
        """The ``swin.stage`` span's attributes for an input map h x w."""
        if self.downsample is not None:
            h, w = -(-h // 2), -(-w // 2)
        attn = self.blocks[0].attn
        pad_h, pad_w, _, _ = window_geometry(h, w, attn.window)
        windows = (pad_h // attn.window) * (pad_w // attn.window)
        n = attn.window * attn.window
        width = attn.proj.out_features
        return dict(images=images, windows=windows, tokens=n, heads=attn.heads,
                    head_dim=width // attn.heads, layers=len(self.blocks),
                    rolled=sum(b.attn.rolls(h, w) for b in self.blocks),
                    dtype=str(dtype).removeprefix("torch."),
                    mask_bytes=sum(b.attn.mask_bytes(h, w, images, dtype) for b in self.blocks),
                    padded_tokens=pad_h * pad_w - h * w)

    def forward(self, x):
        if self.downsample is not None:
            x = self.downsample(x)
        for block in self.blocks:
            x = block(x)
        return x


def graphable(x: torch.Tensor) -> bool:
    """Whether a forward over ``x`` may replay captured stages: ``x`` on
    CUDA, no autograd or autocast, no ``torch`` dispatch or function mode
    (``FlopCounterMode`` counts an eager forward), no capture running."""
    return (x.is_cuda and not torch.is_grad_enabled() and not torch.is_autocast_enabled("cuda")
            and no_mode_active())


class StageGraphs:
    """The backbone's stages for one input shape, each captured as a CUDA
    graph, all in one memory pool: stage i+1's graph reads stage i's
    output where its capture left it. The outputs are overwritten by the
    next replay."""

    def __init__(self, stages: nn.ModuleList, x: torch.Tensor):
        self.stages, self.fingerprint = stages, _versions(stages.parameters())
        self.input = torch.empty_like(x)
        self.graphs: List[torch.cuda.CUDAGraph] = []
        self.outputs: List[torch.Tensor] = []

    def current(self) -> bool:
        return _versions(self.stages.parameters()) == self.fingerprint

    def capture(self) -> bool:
        """Capture every stage (nothing captured runs); on failure warn,
        put back what the capture left behind and return False."""
        device = self.input.device
        stream = torch.cuda.current_stream(device)
        pool = torch.cuda.graph_pool_handle()
        y = self.input
        try:
            with torch.cuda.device(device):
                for stage in self.stages:
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
                        y = stage(y)
                    self.graphs.append(graph)
                    self.outputs.append(y)
            return True
        except RuntimeError as e:
            warnings.warn(f"the Swin stages could not be captured as CUDA graphs ({e}); "
                          "they run eagerly for this input shape", RuntimeWarning)
            after_failed_capture(device, stream, pool)
            self.graphs, self.outputs = [], []
            return False

    def replay(self, x: torch.Tensor, spans: List[Dict]) -> List[torch.Tensor]:
        """Copy ``x`` into the static input and replay the stages, each in
        its ``swin.stage`` span (attributes ``spans``)."""
        self.input.copy_(x)
        for graph, attrs in zip(self.graphs, spans):
            with span("swin.stage", **attrs):
                graph.replay()
        return self.outputs


class SwinBackbone(nn.Module):
    def __init__(self, bands: int, patch: int, embed: int, depths: Sequence[int],
                 heads: Sequence[int], window: int, mlp_ratio: int):
        super().__init__()
        self.patch_embed = nn.Conv2d(bands, embed, patch, stride=patch)
        self.norm = nn.LayerNorm(embed, eps=LN_EPS)
        self.stages = nn.ModuleList(
            Stage(embed * 2 ** i, d, hd, window, mlp_ratio, merge=i > 0)
            for i, (d, hd) in enumerate(zip(depths, heads)))
        # per input signature, least recently used first: eager forwards
        # seen, or its StageGraphs (None: its capture failed)
        self._graphs: "OrderedDict[Tuple, object]" = OrderedDict()

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """(N, bands, H, W) -> (N, H/p, W/p, embed)."""
        return self.norm(self.patch_embed(x).permute(0, 2, 3, 1))

    def graphs(self, y: torch.Tensor) -> Optional[StageGraphs]:
        """The captured stages to replay over ``y`` (captured now on the
        shape's third graphable forward), or None for an eager forward."""
        if not graphable(y):
            return None
        key = (tuple(y.shape), y.dtype, y.device)
        seen = self._graphs.get(key, 0)
        if key in self._graphs:
            self._graphs.move_to_end(key)
        if isinstance(seen, StageGraphs):
            if seen.current():
                return seen
            seen = 0
        if seen is None:
            return None
        if seen < EAGER_CALLS or torch.autograd.profiler._is_profiler_enabled:
            self._graphs[key] = seen + 1
            graphs = None
        else:
            graphs = StageGraphs(self.stages, y)
            if not graphs.capture():
                graphs = None
            self._graphs[key] = graphs
        while len(self._graphs) > MAX_GRAPHS:
            self._graphs.popitem(last=False)
        return graphs

    def stage_attrs(self, y: torch.Tensor) -> List[Dict]:
        """Each stage's ``swin.stage`` attributes for the embedded map ``y``."""
        out, (n, h, w) = [], y.shape[:3]
        for i, stage in enumerate(self.stages):
            out.append(dict(stage=i, **stage.attrs(h, w, n, y.dtype)))
            if stage.downsample is not None:  # the stage's output map
                h, w = -(-h // 2), -(-w // 2)
        return out


class FPN(nn.Module):
    """torchvision's feature pyramid, its stride-4 output alone."""

    def __init__(self, in_channels: Sequence[int], width: int):
        super().__init__()
        self.inner_blocks = nn.ModuleList(nn.Conv2d(c, width, 1) for c in in_channels)
        self.layer_block = nn.Conv2d(width, width, 3, padding=1)

    def forward(self, feats: List[torch.Tensor]) -> torch.Tensor:
        y = self.inner_blocks[-1](feats[-1])
        for i in range(len(feats) - 2, -1, -1):
            lateral = self.inner_blocks[i](feats[i])
            y = lateral + F.interpolate(y, size=lateral.shape[-2:], mode="nearest")
        return self.layer_block(y)


def _conv_relu(module: nn.Module, conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``relu(conv(x))``, the bias and ReLU in the hand-written epilogue
    where its route holds (``models.blocks.epilogue_route``; the kernels
    run on CUDA alone)."""
    if x.is_cuda and epilogue_route(module, True, (x,), conv.out_channels):
        return conv_bias_relu_(conv, x)
    return F.relu(conv(x))


class UpsampleStep(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, in_ch, 3, padding=1)
        self.up = nn.ConvTranspose2d(in_ch, out_ch, 4, stride=2, padding=1)

    def forward(self, x):
        return _conv_relu(self, self.up, _conv_relu(self, self.conv, x))


class SegmentHead(nn.Module):
    def __init__(self, in_ch: int, width: int, n_classes: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, width, 3, padding=1)
        self.out = nn.Conv2d(width, n_classes, 3, padding=1)

    def forward(self, x):
        return self.out(_conv_relu(self, self.conv, x))


class SatlasSwinSegmenter(nn.Module):
    """The multi-image Swin-v2 backbone, max over dates, FPN and head
    (module doc). ``in_channels`` is the stack the engine sees, ``frames``
    times the bands; the defaults are Swin-v2-Base's and Satlas's."""

    def __init__(
        self,
        in_channels: int,
        frames: int = 4,
        patch: int = 4,
        embed: int = 128,
        depths: Sequence[int] = (2, 2, 18, 2),
        heads: Sequence[int] = (4, 8, 16, 32),
        window: int = 8,
        mlp_ratio: int = 4,
        fpn: int = 128,
        upsample_widths: Sequence[int] = (128, 128),
        head_width: int = 128,
        n_classes: int = 1,
        head: str = "sigmoid",
        threshold: float = 0.5,
        scale: Optional[Sequence[float]] = None,
    ):
        super().__init__()
        if in_channels % frames:
            raise ValueError(f"{in_channels} channels are not {frames} frames of equal bands")
        if head not in ("sigmoid", "softmax"):
            raise ValueError(f"unknown head {head!r}")
        if len(depths) != len(heads):
            raise ValueError(f"{len(depths)} stage depths for {len(heads)} head counts")
        if 2 ** len(upsample_widths) != patch:
            raise ValueError(f"{len(upsample_widths)} upsampling steps do not undo patches "
                             f"of {patch}")
        bands = in_channels // frames
        if scale is not None and len(scale) != bands:
            raise ValueError(f"scale has {len(scale)} values for {bands} bands")
        self.kwargs = dict(
            in_channels=in_channels, frames=frames, patch=patch, embed=embed,
            depths=tuple(depths), heads=tuple(heads), window=window, mlp_ratio=mlp_ratio,
            fpn=fpn, upsample_widths=tuple(upsample_widths), head_width=head_width,
            n_classes=n_classes, head=head, threshold=threshold,
            scale=None if scale is None else tuple(scale))
        self.frames, self.bands, self.patch = frames, bands, patch
        self.head_kind, self.threshold = head, threshold
        self.backbone = SwinBackbone(bands, patch, embed, depths, heads, window, mlp_ratio)
        self.fpn = FPN([embed * 2 ** i for i in range(len(depths))], fpn)
        chans = [fpn, *upsample_widths]
        self.upsample = nn.ModuleList(UpsampleStep(a, b) for a, b in zip(chans, upsample_widths))
        self.head = SegmentHead(chans[-1], head_width, n_classes)
        self._scales: Dict[torch.device, torch.Tensor] = {}
        swin_init_(self)

    def _scaled(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, frames * bands) -> (B, H, W, frames, bands) float32,
        each band over its scale, clipped to [0, 1]; without ``scale`` the
        input as it is (already scaled, as a config's preprocess leaves
        it)."""
        b, h, w, _ = x.shape
        x = x.float().view(b, h, w, self.frames, self.bands)
        if self.kwargs["scale"] is None:
            return x
        if x.device not in self._scales:
            self._scales[x.device] = torch.tensor(self.kwargs["scale"], dtype=torch.float32,
                                                  device=x.device)
        return (x / self._scales[x.device]).clamp_(0.0, 1.0)

    def forward(self, x: torch.Tensor):
        """(B, H, W, frames * bands) -> dict of (B, H, W, n_classes)
        float32 outputs (``classes`` int32 (B, H, W) for softmax); H and W
        multiples of ``patch``."""
        b, h, w, _ = x.shape
        t, p, bb = self.frames, self.patch, self.backbone
        if h % p or w % p:
            raise ValueError(f"a {h}x{w} input is not a whole number of {p}x{p} patches")
        dtype = self.head.out.weight.dtype
        images = b * t
        with span("swin.embed", images=images):
            frames = (self._scaled(x).to(dtype).permute(0, 3, 1, 2, 4)
                      .reshape(images, h, w, self.bands).permute(0, 3, 1, 2))
            y = bb.embed(frames)
        spans = bb.stage_attrs(y)
        graphs = bb.graphs(y)
        if graphs is not None:
            feats = graphs.replay(y, spans)
        else:
            feats = []
            for stage, attrs in zip(bb.stages, spans):
                with span("swin.stage", **attrs):
                    y = stage(y)
                feats.append(y)
        with span("satlas.aggregate", images=images, frames=t):
            # (B * frames, h, w, C) -> (B, C, h, w), channels-last in memory
            feats = [f.reshape(b, t, *f.shape[1:]).amax(dim=1).permute(0, 3, 1, 2)
                     for f in feats]
        with span("satlas.fpn", chips=b):
            y = self.fpn(feats)
        with span("satlas.head", chips=b):
            for step in self.upsample:
                y = step(y)
            logits = self.head(y).float().permute(0, 2, 3, 1).contiguous()
        if self.head_kind == "softmax":
            probs = torch.softmax(logits, dim=-1)
            return {"logits": logits, "probs": probs,
                    "classes": torch.argmax(probs, dim=-1).to(torch.int32)}
        probs = torch.sigmoid(logits)
        return {"logits": logits, "probs": probs,
                "classes": (probs > self.threshold).to(torch.int32)}


def swin_init_(model: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Reset ``model``'s weights in place as torchvision initialises a
    Swin transformer: every linear map (the position-bias MLP's too)
    truncated-normal with std 0.02, zero biases, LayerNorm 1 and 0, each
    ``logit_scale`` log 10; the convs and transposed convs He-uniform
    (PyTorch's default), zero biases."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                nn.init.trunc_normal_(mod.weight, std=0.02, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.reset_parameters()
            elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                nn.init.kaiming_uniform_(mod.weight, a=math.sqrt(5), generator=generator)
                mod.bias.zero_()
            elif isinstance(mod, WindowAttention):
                mod.logit_scale.fill_(math.log(10.0))
    return model

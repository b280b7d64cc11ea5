"""fused_preprocess: per-chip recolor + min/max rescale + flip/rot90.

Port of ``satellite_computervision_tpu/pallas/preprocess.py``. For a
(B, K, K, C) float32 chip stack, the leading ``n_color`` channels of each
chip are recolored (``(v - mean)*contra + mean*bright``, when augmenting)
and min/max rescaled per channel (axes (0, 1)); the trailing channels
(one-hot features, labels) pass through; when augmenting, every channel of
a chip shares its flip-v / flip-h / rot90.

- On a CUDA tensor :func:`fused_preprocess` makes one launch of the
  hand-written kernel in ``csrc/fused_preprocess.cu`` (built by
  ``kernels/_build.py``; a thread-block cluster per chip) or raises. It
  reads the stack NHWC as the pipeline builds it and writes the morph
  through the store index.
- On a CPU tensor it runs :func:`fused_preprocess_reference`, the plain
  PyTorch version, which the tests hold against the JAX package and
  ``chip_smoke.py`` holds the kernel against on the card.
- :func:`fused_preprocess_stats_reference` is the kernel's algebra in plain
  PyTorch (the raw per-plane sum, min and max, then the recolored extrema
  through the sign of ``contra``); the CPU tests hold it against the plain
  version. Nothing on the main path calls it.

The draws come from :func:`draw_augment_params` on an explicit generator
and are passed in: torch's draws never equal JAX's, so the tests inject
the JAX package's ``draw_augment_params`` instead.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from satellite_computervision_tpu_torch.ops.augment import apply_morph


def draw_augment_params(generator: Optional[torch.Generator], batch: int, channels: int,
                        contra_adj: float = 0.05, bright_adj: float = 0.05,
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-chip draws: ``contra``/``bright`` (batch, channels) float32,
    uniform in ``1 ± adj``, and ``morph`` (batch, 3) int32 = (flip_v,
    flip_h, n_rot90) with Bernoulli(0.5) flips and a rotation uniform over
    {0, 1, 2, 3}. Drawn on the generator's device (CPU by default)."""
    contra = torch.rand((batch, channels), generator=generator) * (2 * contra_adj) + (1 - contra_adj)
    bright = torch.rand((batch, channels), generator=generator) * (2 * bright_adj) + (1 - bright_adj)
    flips = (torch.rand((batch, 2), generator=generator) < 0.5).to(torch.int32)
    rot = torch.randint(0, 4, (batch, 1), generator=generator, dtype=torch.int32)
    return contra, bright, torch.cat([flips, rot], dim=1)


def _check(bands: torch.Tensor, n_color, augment, contra, bright, morph) -> int:
    if bands.dim() != 4:
        raise ValueError("bands must be (B, K, K, C)")
    b, k, k2, c = bands.shape
    if k != k2:
        raise ValueError("chips must be square for rot90 augmentation")
    n_color = c if n_color is None else int(n_color)
    if not 0 <= n_color <= c:
        raise ValueError(f"n_color {n_color} outside [0, {c}]")
    if augment:
        if contra is None or bright is None or morph is None:
            raise ValueError("augment=True requires draws (contra, bright, morph); "
                             "see draw_augment_params")
        for name, p in (("contra", contra), ("bright", bright)):
            if p.dim() != 2 or p.shape[0] != b or p.shape[1] < n_color:
                raise ValueError(f"{name} must be (B, >= n_color), got {tuple(p.shape)}")
        if tuple(morph.shape) != (b, 3):
            raise ValueError(f"morph must be (B, 3), got {tuple(morph.shape)}")
    return n_color


def _rescale_and_morph(x: torch.Tensor, col: torch.Tensor, lo, hi, n_color: int,
                       morph, augment: bool) -> torch.Tensor:
    out = torch.cat([(col - lo) / (hi - lo + 1e-8), x[..., n_color:]], dim=-1)
    if augment:
        out = torch.stack([apply_morph(chip, *m) for chip, m in zip(out, morph.tolist())])
    return out


def _recolor_params(contra, bright, n_color: int, device):
    return tuple(p[:, :n_color].to(device, torch.float32)[:, None, None, :]
                 for p in (contra, bright))


def fused_preprocess_reference(bands: torch.Tensor, n_color: Optional[int] = None,
                               contra=None, bright=None, morph=None,
                               augment: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_preprocess` (any device):
    recolor -> per-channel min/max rescale of the color channels, then each
    chip's ``apply_morph``."""
    n_color = _check(bands, n_color, augment, contra, bright, morph)
    x = bands.float()
    col = x[..., :n_color]
    if augment:
        mean = col.mean(dim=(1, 2), keepdim=True)
        ct, br = _recolor_params(contra, bright, n_color, x.device)
        col = (col - mean) * ct + mean * br
    lo = col.amin(dim=(1, 2), keepdim=True)
    hi = col.amax(dim=(1, 2), keepdim=True)
    return _rescale_and_morph(x, col, lo, hi, n_color, morph, augment)


def recolored_extrema(vmin, vmax, mean, contra, bright):
    """(lo, hi) of the recolored plane ``(v - mean)*contra + mean*bright``
    from the raw plane's ``vmin`` and ``vmax``.

    Each step of the recolor is monotone in v and float rounding is
    monotone, so the recolor is non-decreasing for ``contra >= 0`` and
    non-increasing for ``contra < 0``: its extrema are the recolored raw
    extrema, swapped where ``contra < 0`` (for ``contra == 0`` both are
    ``mean*bright``). Where an infinity makes a recolored value NaN
    (``inf - inf``, ``inf * 0``), it does so at an extreme of v; the plane
    then holds a NaN and both extrema are NaN, as ``amin``/``amax`` give.
    Arguments broadcast together."""
    at_min = (vmin - mean) * contra + mean * bright
    at_max = (vmax - mean) * contra + mean * bright
    neg = contra < 0
    lo, hi = torch.where(neg, at_max, at_min), torch.where(neg, at_min, at_max)
    nan = torch.isnan(at_min) | torch.isnan(at_max)
    return lo.masked_fill(nan, float("nan")), hi.masked_fill(nan, float("nan"))


def fused_preprocess_stats_reference(bands: torch.Tensor, n_color: Optional[int] = None,
                                     contra=None, bright=None, morph=None,
                                     augment: bool = True) -> torch.Tensor:
    """The kernel's algebra in plain PyTorch: the raw (sum, min, max) of
    each chip's color planes, the mean as sum / K², the recolored extrema
    from :func:`recolored_extrema`, then the rescale and ``apply_morph``.
    Equal to :func:`fused_preprocess_reference` up to the order of the
    mean's sum; held against it by the CPU tests."""
    n_color = _check(bands, n_color, augment, contra, bright, morph)
    x = bands.float()
    col = x[..., :n_color]
    lo = col.amin(dim=(1, 2), keepdim=True)
    hi = col.amax(dim=(1, 2), keepdim=True)
    if augment:
        mean = col.sum(dim=(1, 2), keepdim=True) / (col.shape[1] * col.shape[2])
        ct, br = _recolor_params(contra, bright, n_color, x.device)
        lo, hi = recolored_extrema(lo, hi, mean, ct, br)
        col = (col - mean) * ct + mean * br
    return _rescale_and_morph(x, col, lo, hi, n_color, morph, augment)


def _device_draws(contra, bright, morph, device) -> Tuple[torch.Tensor, ...]:
    """``contra``, ``bright`` (B, S) float32 and ``morph`` (B, 3) int32 on
    ``device``. Draws on the host go as one packed pinned buffer of 32-bit
    words in one ``non_blocking`` copy (pageable copies would each
    synchronise the stream); draws already on the device are used as they
    are."""
    contra = contra.to(dtype=torch.float32).contiguous()
    bright = bright.to(dtype=torch.float32).contiguous()
    morph = morph.to(dtype=torch.int32).contiguous()
    if bright.shape[1] != contra.shape[1]:
        raise ValueError("contra and bright must have the same width")
    if all(t.device == device for t in (contra, bright, morph)):
        return contra, bright, morph
    words = [t.cpu().view(torch.int32).reshape(-1) for t in (contra, bright, morph)]
    host = torch.empty(sum(w.numel() for w in words), dtype=torch.int32, pin_memory=True)
    torch.cat(words, out=host)
    packed = host.to(device, non_blocking=True)
    n = contra.numel()
    return (packed[:n].view(torch.float32).view(contra.shape),
            packed[n:2 * n].view(torch.float32).view(bright.shape),
            packed[2 * n:].view(morph.shape))


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry point, built and loaded at the first call."""
    from satellite_computervision_tpu_torch.kernels import _build

    fn = _build.load("fused_preprocess").fused_preprocess_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_preprocess(bands: torch.Tensor, n_color: Optional[int] = None,
                     contra=None, bright=None, morph=None,
                     augment: bool = True) -> torch.Tensor:
    """(B, K, K, C) chip stack -> preprocessed stack (float32).

    ``n_color`` (default C) leading channels are recolored (if
    ``augment``) and min/max rescaled per chip and channel; all channels
    share the chip's flip/rot90 (if ``augment``). ``contra``/``bright``
    (B, >= n_color) and ``morph`` (B, 3) are the draws of
    :func:`draw_augment_params`; ``augment=True`` without them raises.

    CUDA tensors go through one launch of the hand-written kernel (each
    call adds one to ``fused_preprocess.launches``); CPU tensors through
    :func:`fused_preprocess_reference`."""
    n_color = _check(bands, n_color, augment, contra, bright, morph)
    if bands.device.type == "cpu":
        return fused_preprocess_reference(bands, n_color, contra, bright, morph, augment)
    if bands.device.type != "cuda":
        raise ValueError(f"fused_preprocess: unsupported device {bands.device}")
    if bands.dtype != torch.float32:
        raise ValueError(f"fused_preprocess: float32 input required, got {bands.dtype}")
    if not bands.is_contiguous():
        raise ValueError("fused_preprocess: input must be contiguous")
    b, k, _, c = bands.shape
    if c > 1024:
        raise ValueError("fused_preprocess: at most 1024 channels")
    if b > 65535 or k * k * c >= 2**31:
        raise ValueError("fused_preprocess: at most 65535 chips of < 2**31 floats each")
    fn = _entry()
    dev = bands.device
    if augment:
        draws = _device_draws(contra, bright, morph, dev)
        params, stride = tuple(d.data_ptr() for d in draws), draws[0].shape[1]
    else:
        params, stride = (None, None, None), 0
    out = torch.empty_like(bands)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(bands.data_ptr(), *params, out.data_ptr(), b, k, c, n_color,
                 int(augment), stride, stream)
    if err != 0:
        raise RuntimeError(f"fused_preprocess kernel launch failed (cudaError {err})")
    fused_preprocess.launches += 1
    return out


fused_preprocess.launches = 0

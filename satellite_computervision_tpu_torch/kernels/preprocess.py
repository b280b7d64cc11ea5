"""fused_preprocess: per-chip recolor + min/max rescale + flip/rot90.

Port of ``satellite_computervision_tpu/pallas/preprocess.py``. For a
(B, K, K, C) float32 chip stack, the leading ``n_color`` channels of each
chip are recolored (``(v - mean)*contra + mean*bright``, when augmenting)
and min/max rescaled per channel (axes (0, 1)); the trailing channels
(one-hot features, labels) pass through; when augmenting, every channel of
a chip shares its flip-v / flip-h / rot90.

- On a CUDA tensor :func:`fused_preprocess` launches the hand-written
  kernel in ``csrc/fused_preprocess.cu`` (built by ``kernels/_build.py``)
  or raises. It reads the stack NHWC as the pipeline builds it and writes
  the morph through the store index.
- On a CPU tensor it runs :func:`fused_preprocess_reference`, the plain
  PyTorch version, which the tests hold against the JAX package and
  ``chip_smoke.py`` holds the kernel against on the card.

The draws come from :func:`draw_augment_params` on an explicit generator
and are passed in: torch's draws never equal JAX's, so the tests inject
the JAX package's ``draw_augment_params`` instead.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from satellite_computervision_tpu_torch.ops.augment import apply_morph

# blocks per chip: 64 chips x 16 tiles = 1024 blocks over 132 SMs
TILES = 16


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
        ct = contra[:, :n_color].to(x.device, torch.float32)[:, None, None, :]
        br = bright[:, :n_color].to(x.device, torch.float32)[:, None, None, :]
        col = (col - mean) * ct + mean * br
    lo = col.amin(dim=(1, 2), keepdim=True)
    hi = col.amax(dim=(1, 2), keepdim=True)
    out = torch.cat([(col - lo) / (hi - lo + 1e-8), x[..., n_color:]], dim=-1)
    if augment:
        out = torch.stack([apply_morph(chip, *m) for chip, m in zip(out, morph.tolist())])
    return out


def fused_preprocess(bands: torch.Tensor, n_color: Optional[int] = None,
                     contra=None, bright=None, morph=None,
                     augment: bool = True) -> torch.Tensor:
    """(B, K, K, C) chip stack -> preprocessed stack (float32).

    ``n_color`` (default C) leading channels are recolored (if
    ``augment``) and min/max rescaled per chip and channel; all channels
    share the chip's flip/rot90 (if ``augment``). ``contra``/``bright``
    (B, >= n_color) and ``morph`` (B, 3) are the draws of
    :func:`draw_augment_params`; ``augment=True`` without them raises.

    CUDA tensors go through the hand-written kernel (each call adds one to
    ``fused_preprocess.launches``); CPU tensors through
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
    from satellite_computervision_tpu_torch.kernels import _build

    lib = _build.load("fused_preprocess")
    fn = lib.fused_preprocess_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = bands.device
    if augment:
        contra = contra.to(dev, torch.float32).contiguous()
        bright = bright.to(dev, torch.float32).contiguous()
        morph = morph.to(dev, torch.int32).contiguous()
        params = (contra.data_ptr(), bright.data_ptr(), morph.data_ptr())
        stride = contra.shape[1]
        if bright.shape[1] != stride:
            raise ValueError("contra and bright must have the same width")
    else:
        params, stride = (None, None, None), 0
    out = torch.empty_like(bands)
    scratch = torch.empty(3 * b * TILES * c, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(bands.data_ptr(), *params, out.data_ptr(), scratch.data_ptr(),
                 b, k, c, n_color, int(augment), TILES, stride, stream)
    if err != 0:
        raise RuntimeError(f"fused_preprocess kernel launch failed (cudaError {err})")
    fused_preprocess.launches += 1
    return out


fused_preprocess.launches = 0

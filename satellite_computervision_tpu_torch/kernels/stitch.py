"""hann_stitch: one-pass hann-blend canvas assembly.

Port of ``satellite_computervision_tpu/pallas/stitch.py``. The engine's
overlap-tile blend (inference/tiles.py) stitches hann-weighted chips on a
stride-``kernel`` grid where every output pixel sums up to 4 overlapping
chips, then normalizes by the (input-independent, separable) hann weight
sum. With ``apply_window=True`` the chips arrive unweighted and the window
is applied inside the same pass (the engine's route); without it they
arrive hann-weighted (the TPU kernel's function).

- On a CUDA tensor :func:`hann_stitch` launches the hand-written kernel in
  ``csrc/hann_stitch.cu`` (built by ``kernels/_build.py``) or raises.
- On a CPU tensor it runs :func:`hann_stitch_reference`, the plain PyTorch
  quadrant-add version, which the tests hold against the JAX package and
  ``chip_smoke.py`` holds the kernel against on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hann_window_1d(side: int) -> np.ndarray:
    """The engine's 1-D hann edge profile (float32, clipped away from 0).

    Single source of truth: the 2-D chip weight is the outer product of
    this (``hann_stitch(..., apply_window=True)`` multiplies it in) and the
    blend normalizer below divides it back out — both must come from here
    or hann output is silently mis-scaled."""
    n1 = np.arange(side, dtype=np.float32)
    return np.sqrt(
        np.clip(0.5 - 0.5 * np.cos(2.0 * np.pi * (n1 + 0.5) / side), 1e-4, None)
    ).astype(np.float32)


def _axis_weight_sum(n: int, kernel: int, side: int) -> np.ndarray:
    """Sum of ``n`` 1-D windows placed at stride ``kernel`` over an axis of
    length ``(n + 1) * kernel``."""
    w1 = hann_window_1d(side)
    w = np.zeros((n + 1) * kernel, np.float32)
    for i in range(n):
        w[i * kernel : i * kernel + side] += w1
    return w


def hann_inverse_weights(rows: int, cols: int, kernel: int, side: int) -> np.ndarray:
    """Constant 1/sum-of-hann-weights canvas ((rows+1)*k, (cols+1)*k).

    Separable: every chip window is the same ``w1 (x) w1`` outer product
    placed on the stride-``kernel`` grid, so the weight sum factorizes
    into per-axis sums."""
    wy = _axis_weight_sum(rows, kernel, side)
    wx = _axis_weight_sum(cols, kernel, side)
    return 1.0 / np.maximum(wy[:, None] * wx[None, :], 1e-8)


def hann_window_2d(side: int, device) -> torch.Tensor:
    """The (side, side) chip weight: the outer product of
    :func:`hann_window_1d`, in float32 on ``device``."""
    w1 = torch.from_numpy(hann_window_1d(side)).to(device)
    return w1[:, None] * w1[None, :]


def _check(chips: torch.Tensor, kernel: int, rows: int, cols: int) -> int:
    if chips.dim() != 4:
        raise ValueError("chips must be (rows*cols, side, side, c_out)")
    n, side, side2, _ = chips.shape
    if side != side2 or n != rows * cols:
        raise ValueError("chips must be (rows*cols, side, side, c_out)")
    if side > 2 * kernel:
        raise ValueError("hann stitching requires side <= 2*kernel")
    return side


def _check_row_weights(row_weights: torch.Tensor, kernel: int, rows: int, device) -> None:
    if row_weights.shape != ((rows + 1) * kernel,) or row_weights.dtype != torch.float32:
        raise ValueError("row_weights must be float32 of shape ((rows+1)*kernel,)")
    if row_weights.device != device:
        raise ValueError(f"row_weights on {row_weights.device}, chips on {device}")


def hann_stitch_reference(chips: torch.Tensor, kernel: int, rows: int, cols: int,
                          apply_window: bool = False,
                          row_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: with ``apply_window`` the chips are first
    multiplied by :func:`hann_window_2d`; each weighted chip, padded to a
    (2k, 2k) block, splits into four (k, k) quadrants that land on the
    kernel grid; the blend is 4 shifted adds of reshape-stitched quadrant
    grids, times the inverse weight canvas ``1 / max(wy * wx, 1e-8)``
    (``wy`` the grid's own row sums, or ``row_weights``). Runs on any
    device."""
    side = _check(chips, kernel, rows, cols)
    k = kernel
    c_out = chips.shape[-1]
    canvas_h, canvas_w = (rows + 1) * k, (cols + 1) * k
    weighted = chips.float()
    if apply_window:
        weighted = weighted * hann_window_2d(side, chips.device)[..., None]
    blocks = weighted.reshape(rows, cols, side, side, c_out)
    blocks = F.pad(blocks, (0, 0, 0, 2 * k - side, 0, 2 * k - side))
    quads = (
        blocks.reshape(rows, cols, 2, k, 2, k, c_out)
        .permute(2, 4, 0, 3, 1, 5, 6)
        .reshape(2, 2, rows * k, cols * k, c_out)
    )
    acc = torch.zeros((canvas_h, canvas_w, c_out), dtype=torch.float32,
                      device=chips.device)
    for a in (0, 1):
        for b in (0, 1):
            acc = acc + F.pad(
                quads[a, b],
                (0, 0, b * k, canvas_w - cols * k - b * k,
                 a * k, canvas_h - rows * k - a * k),
            )
    if row_weights is None:
        inv_w = torch.from_numpy(hann_inverse_weights(rows, cols, k, side))
    else:
        _check_row_weights(row_weights, k, rows, chips.device)
        wy = row_weights.detach().cpu().numpy()
        wx = _axis_weight_sum(cols, k, side)
        inv_w = torch.from_numpy(1.0 / np.maximum(wy[:, None] * wx[None, :], 1e-8))
    return acc * inv_w.to(chips.device)[..., None]


@functools.lru_cache(maxsize=16)
def _device_axis_weights(rows: int, cols: int, kernel: int, side: int,
                         device: torch.device):
    """(wy, wx) on ``device``, cached so a launch does no host-to-device
    copy after the first one for a grid."""
    return tuple(
        torch.from_numpy(_axis_weight_sum(n, kernel, side)).to(device)
        for n in (rows, cols)
    )


@functools.lru_cache(maxsize=16)
def _device_window_1d(side: int, device: torch.device) -> torch.Tensor:
    """:func:`hann_window_1d` on ``device``, cached like the axis sums."""
    return torch.from_numpy(hann_window_1d(side)).to(device)


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry point, built and loaded at the first call."""
    from satellite_computervision_tpu_torch.kernels import _build

    fn = _build.load("hann_stitch").hann_stitch_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def hann_stitch(chips: torch.Tensor, kernel: int, rows: int, cols: int,
                apply_window: bool = False,
                row_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Assemble chips into the normalized blended canvas.

    ``chips``: (rows*cols, side, side, c_out) float32, contiguous, chip
    predictions on the stride-``kernel`` grid (chip (r, c) at canvas
    (r*k, c*k)): hann-weighted, or raw with ``apply_window=True`` (the
    kernel then weights each pixel by ``w1[sy] * w1[sx]`` itself). Returns
    (canvas_h, canvas_w, c_out) float32 with canvas_h = (rows+1)*k.

    ``row_weights`` ((rows+1)*k float32 on the chips' device) replaces the
    grid's own row sum of windows in the normalizer: a band of a larger
    grid (``parallel/spatial.py``) normalizes by the whole grid's sums,
    mapped onto its canvas rows.

    CUDA tensors go through the hand-written kernel (each launch adds one
    to ``hann_stitch.launches``); CPU tensors through
    :func:`hann_stitch_reference`."""
    side = _check(chips, kernel, rows, cols)
    if chips.device.type == "cpu":
        return hann_stitch_reference(chips, kernel, rows, cols, apply_window, row_weights)
    if chips.device.type != "cuda":
        raise ValueError(f"hann_stitch: unsupported device {chips.device}")
    if chips.dtype != torch.float32:
        raise ValueError(f"hann_stitch: float32 input required, got {chips.dtype}")
    if not chips.is_contiguous():
        raise ValueError("hann_stitch: input must be contiguous")
    fn = _entry()
    c_out = chips.shape[-1]
    wy, wx = _device_axis_weights(rows, cols, kernel, side, chips.device)
    if row_weights is not None:
        _check_row_weights(row_weights, kernel, rows, chips.device)
        wy = row_weights.contiguous()
    w1 = _device_window_1d(side, chips.device)
    out = torch.empty(((rows + 1) * kernel, (cols + 1) * kernel, c_out),
                      dtype=torch.float32, device=chips.device)
    with torch.cuda.device(chips.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(chips.data_ptr(), w1.data_ptr(), wy.data_ptr(), wx.data_ptr(),
                 out.data_ptr(), rows, cols, kernel, side, c_out, int(apply_window), stream)
    if err != 0:
        raise RuntimeError(f"hann_stitch kernel launch failed (cudaError {err})")
    hann_stitch.launches += 1
    return out


hann_stitch.launches = 0

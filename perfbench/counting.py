"""Operations, bytes and peaks: the arithmetic behind ``mfu.*`` and the
kernels' roofline shares.

- :func:`count_flops`: floating-point operations of one call, 2 per
  multiply-add of every convolution and matmul (forward and, when the
  call runs a backward, backward), counted from shapes by PyTorch's
  ``FlopCounterMode``. Elementwise work is not counted.
- :func:`hann_stitch_bytes` and :func:`fused_preprocess_bytes`: the bytes
  each kernel must move at least, every input byte read once and every
  output byte written once. Both kernels do a few operations per byte,
  far below the card's ratio of FLOP/s to bytes/s, so their least time is
  bytes over the memory bandwidth.
- :data:`PEAKS`: published dense peaks of a card, by the name
  ``torch.cuda.get_device_name`` gives (NVIDIA's H100 SXM data sheet; the
  rates assume the 700 W power limit).
"""

from __future__ import annotations

from typing import Callable, Optional

F32 = 4

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flop_s": 989e12, "hbm_byte_s": 3.35e12, "power_w": 700.0},
}


def peak(device_name: str, key: str) -> Optional[float]:
    row = PEAKS.get(device_name)
    return None if row is None else row[key]


def count_flops(fn: Callable) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return counter.get_total_flops()


def hann_stitch_bytes(rows: int, cols: int, kernel: int, side: int, channels: int = 1) -> int:
    """One stitch of a rows x cols grid of float32 chips of ``side``:
    the chips, the 1-D window and the two axis weight sums read, the
    ((rows + 1)*kernel, (cols + 1)*kernel) float32 canvas written."""
    chips = rows * cols * side * side * channels
    weights = side + (rows + 1) * kernel + (cols + 1) * kernel
    canvas = (rows + 1) * kernel * (cols + 1) * kernel * channels
    return F32 * (chips + weights + canvas)


def fused_preprocess_bytes(batch: int, k: int, channels: int, n_color: int,
                           augment: bool = True) -> int:
    """One call on a (batch, k, k, channels) float32 stack: read once,
    written once, and with ``augment`` the draws (contra and bright of
    ``n_color`` floats, three int32 morph words per chip) read."""
    stack = batch * k * k * channels
    draws = batch * (2 * n_color + 3) if augment else 0
    return F32 * (2 * stack + draws)

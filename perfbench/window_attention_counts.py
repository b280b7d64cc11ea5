"""Operations and bytes of a Swin stage's windowed attention, the
arithmetic behind ``swin_attn_roofline``.

Each of a stage's ``layers`` blocks makes one call of
``F.scaled_dot_product_attention`` over ``images`` maps of ``windows``
windows each, every window ``tokens`` long with ``heads`` heads of
``head_dim``: per window and head ``Q K^T`` and ``P V``, 2 FLOPs a
multiply-add each, so ``4 N^2 d`` (the softmax's work not counted); bytes:
Q, K and V read once and O written once, ``4 N d`` values a window-head,
plus the mask's distinct values read once: the position bias plus the
shift mask, ``heads N^2`` a window in each of the ``rolled`` calls (the
same for every image), ``heads N^2`` in a call that does not roll. How
the program lays the mask out (its ``mask_bytes``, a copy for every
image) does not count. The least time on a card is the larger of the
FLOPs over the bf16 peak and the bytes over the memory bandwidth
(``perfbench.counting.PEAKS``). The program's ``swin.stage`` spans carry
these shapes and the attention's ``dtype``.
"""

from __future__ import annotations

from perfbench.attention_counts import BYTES


def window_heads(attrs: dict) -> int:
    return attrs["layers"] * attrs["images"] * attrs["windows"] * attrs["heads"]


def stage_flops(attrs: dict) -> int:
    return 4 * window_heads(attrs) * attrs["tokens"] ** 2 * attrs["head_dim"]


def mask_bytes(attrs: dict) -> int:
    """The distinct bytes of the masks of a stage's calls."""
    copies = attrs["rolled"] * attrs["windows"] + attrs["layers"] - attrs["rolled"]
    return copies * attrs["heads"] * attrs["tokens"] ** 2 * BYTES[attrs["dtype"]]


def stage_bytes(attrs: dict) -> int:
    qkvo = 4 * window_heads(attrs) * attrs["tokens"] * attrs["head_dim"] * BYTES[attrs["dtype"]]
    return qkvo + mask_bytes(attrs)


def stage_least_s(attrs: dict, flop_s: float, byte_s: float) -> float:
    """Least time of the attention calls of a ``swin.stage`` span with
    ``attrs``."""
    return max(stage_flops(attrs) / flop_s, stage_bytes(attrs) / byte_s)

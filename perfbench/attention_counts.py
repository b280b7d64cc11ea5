"""Operations and bytes of one attention call, the arithmetic behind
``sdpa_roofline``.

One call of ``F.scaled_dot_product_attention`` over ``chips`` sequences of
``tokens`` with ``heads`` heads of ``head_dim``: per head ``Q K^T`` and
``P V``, 2 FLOPs a multiply-add each, so ``4 N^2 d`` (softmax's work not
counted); bytes: Q, K and V read once and O written once, ``4 N d`` values.
Its least time on a card is the larger of the FLOPs over the bf16 peak and
the bytes over the memory bandwidth (``perfbench.counting.PEAKS``). The
program's ``vit.encoder`` span carries the shapes, its ``layers`` (one
call each) and the attention's ``dtype``.
"""

from __future__ import annotations

BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def sdpa_flops(chips: int, tokens: int, heads: int, head_dim: int) -> int:
    return 4 * chips * heads * tokens * tokens * head_dim


def sdpa_bytes(chips: int, tokens: int, heads: int, head_dim: int, dtype: str) -> int:
    return 4 * chips * heads * tokens * head_dim * BYTES[dtype]


def sdpa_least_s(attrs: dict, flop_s: float, byte_s: float) -> float:
    """Least time of one call with the shapes of a ``vit.encoder`` span's
    ``attrs``."""
    shape = (attrs["chips"], attrs["tokens"], attrs["heads"], attrs["head_dim"])
    return max(sdpa_flops(*shape) / flop_s, sdpa_bytes(*shape, attrs["dtype"]) / byte_s)

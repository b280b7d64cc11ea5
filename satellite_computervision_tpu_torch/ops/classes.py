"""Categorical label reclassification and one-hot encoding.

Port of ``satellite_computervision_tpu/ops/classes.py``.
"""

from __future__ import annotations

import torch


def merge_classes(cond_array: torch.Tensor, trans, out_array=None) -> torch.Tensor:
    """Reclassify values: where ``cond_array == src`` write ``dst``.

    ``trans`` is a sequence of (src, dst) pairs applied in order to a copy
    of ``out_array`` (default ``cond_array``). Later pairs win on overlap;
    the condition array is never mutated, so chains do not cascade."""
    output = (cond_array if out_array is None else out_array).clone()
    for src, dst in trans:
        output = torch.where(cond_array == src,
                             torch.tensor(dst, dtype=output.dtype, device=output.device),
                             output)
    return output


def one_hot(labels: torch.Tensor, depth: int, axis: int = -1,
            dtype=torch.float32) -> torch.Tensor:
    """One-hot encode integer labels along ``axis``. Float labels are
    truncated to integers first; out-of-range values give all-zero rows."""
    if labels.is_floating_point():
        labels = labels.to(torch.int32)
    labels = labels.long()
    classes = torch.arange(depth, device=labels.device)
    out = (labels[..., None] == classes).to(dtype)
    return torch.movedim(out, -1, axis)

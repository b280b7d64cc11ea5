"""Segmentation losses (channels last).

Port of ``satellite_computervision_tpu/models/losses.py``. Inputs are cast
to float32 before any reduction, so bfloat16 activations lose no loss
precision.
"""

from __future__ import annotations

import torch

_KERAS_EPSILON = 1e-7


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).float()


def weighted_categorical_crossentropy(y_true, y_pred, weights, axis: int = -1,
                                      reduce_mean: bool = False) -> torch.Tensor:
    """Per-class-weighted CE on probabilities: renormalize along ``axis``,
    clip to [eps, 1-eps], ``-sum(w * t * log(p))``. Unreduced per pixel
    unless ``reduce_mean``."""
    y_true, y_pred = _f32(y_true), _f32(y_pred)
    weights = _f32(weights).to(y_pred.device).reshape(-1)
    y_pred = y_pred / y_pred.sum(dim=axis, keepdim=True)
    y_pred = y_pred.clamp(_KERAS_EPSILON, 1.0 - _KERAS_EPSILON)
    ce = -(weights * y_true * torch.log(y_pred)).sum(dim=axis)
    return ce.mean() if reduce_mean else ce


def _inverse_square(counts, eps):
    weights = 1.0 / counts**2
    return torch.where(torch.isfinite(weights), weights, torch.full_like(weights, eps))


def gen_dice(y_true, y_pred, eps: float = 1e-6, global_weights=None,
             ref_compat: bool = False, batch_counts: bool = True) -> torch.Tensor:
    """Generalized dice loss on (B, H, W, C) one-hot labels + probabilities,
    class weights ``1/count^2`` (non-finite -> eps). ``batch_counts=True``
    pools the counts over the whole batch (the JAX default);
    ``batch_counts=False`` counts per element; ``ref_compat=True`` sums
    over classes as the reference's shipped code does; ``global_weights``
    overrides the weights."""
    y_true, y_pred = _f32(y_true), _f32(y_pred)
    b, c = y_true.shape[0], y_true.shape[-1]
    y_true = y_true.reshape(b, -1, c)
    y_pred = y_pred.reshape(b, -1, c)
    if global_weights is not None:
        weights = _f32(global_weights).to(y_true.device).reshape(1, c)
    elif ref_compat:
        weights = _inverse_square(y_true.sum(dim=-1), eps)  # (B, H*W)
    elif batch_counts:
        weights = _inverse_square(y_true.sum(dim=(0, 1)), eps).reshape(1, c)
    else:
        weights = _inverse_square(y_true.sum(dim=1), eps)  # (B, C)
    intersect = (y_true * y_pred).sum(dim=1)
    union = (y_true + y_pred).sum(dim=1)
    numer = (weights * intersect).sum(dim=-1)
    denom = (weights * union).sum(dim=-1)
    return (1.0 - 2.0 * numer / denom).mean()


def weighted_bce(y_true, y_pred, pos_weight: float, logits: bool = False) -> torch.Tensor:
    """Positively weighted binary cross entropy, mean-reduced. The
    probability form clips to [1e-5, 1-1e-5]; the logits form is the
    stable ``tf.nn.weighted_cross_entropy_with_logits`` identity
    ``(1-y)*x + (1+(pw-1)*y) * (log1p(exp(-|x|)) + max(-x, 0))``."""
    y_true, y_pred = _f32(y_true), _f32(y_pred)
    if logits:
        log_weight = 1.0 + (pos_weight - 1.0) * y_true
        bce = (1.0 - y_true) * y_pred + log_weight * (
            torch.log1p(torch.exp(-y_pred.abs())) + torch.clamp(-y_pred, min=0.0))
    else:
        p = y_pred.clamp(1e-5, 1.0 - 1e-5)
        bce = y_true * -torch.log(p) * pos_weight + (1.0 - y_true) * -torch.log(1.0 - p)
    return bce.mean()


def iou_loss(y_true, y_pred) -> torch.Tensor:
    """``1 - sum(t*p) / sum(t + (1-t)*p)``."""
    y_true, y_pred = _f32(y_true), _f32(y_pred)
    return 1.0 - (y_true * y_pred).sum() / (y_true + (1.0 - y_true) * y_pred).sum()


def masked_mse(y_true, y_pred) -> torch.Tensor:
    """MSE over the finite-target elements only (NaN-bearing targets).

    The target's non-finite entries are replaced BEFORE the subtraction:
    masking after a NaN-producing op leaks NaN into the gradient (d/dpred
    of 0 * NaN is NaN) and silently NaNs every parameter."""
    y_true, y_pred = _f32(y_true), _f32(y_pred)
    finite = torch.isfinite(y_true)
    diff = (y_pred - torch.where(finite, y_true, torch.zeros_like(y_true))) ** 2
    total = torch.where(finite, diff, torch.zeros_like(diff)).sum()
    return total / finite.sum().clamp(min=1)


# the reference's name for the 4-D masked MSE
mse_4d = masked_mse


def make_loss(name: str, **kwargs):
    """Loss factory keyed by the reference's loss names."""
    table = {
        "weighted_bce": lambda t, p: weighted_bce(t, p, **kwargs),
        "gen_dice": lambda t, p: gen_dice(t, p, **kwargs),
        "weighted_categorical_crossentropy": lambda t, p: weighted_categorical_crossentropy(
            t, p, reduce_mean=True, **kwargs),
        "iou": lambda t, p: iou_loss(t, p),
        "masked_mse": lambda t, p: masked_mse(t, p),
    }
    if name not in table:
        raise KeyError(f"unknown loss {name!r}; options: {sorted(table)}")
    return table[name]

"""Plain reference of a training step: weighted binary cross-entropy on
logits, autograd, and Adam.

- Loss: ``mean((1 - y)*x + (1 + (pw - 1)*y) * (log1p(exp(-|x|)) + max(-x, 0)))``,
  TensorFlow's ``weighted_cross_entropy_with_logits``.
- Adam (Kingma and Ba 2015) with ``betas`` (0.9, 0.999) and ``eps`` 1e-8
  added to the bias-corrected square root:
  ``p -= lr * m_hat / (sqrt(v_hat) + eps)``.
- BatchNorm normalizes by the batch (its running statistics do not enter
  a training step's output).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def weighted_bce_logits(y: torch.Tensor, x: torch.Tensor, pos_weight: float) -> torch.Tensor:
    log_weight = 1.0 + (pos_weight - 1.0) * y
    return ((1.0 - y) * x + log_weight * (torch.log1p(torch.exp(-x.abs()))
                                          + torch.clamp(-x, min=0.0))).mean()


class Adam:
    """Adam over ``params``; ``state`` (``m``, ``v`` and ``t``, each a
    dict by leaf) continues a run where it stood, and is fresh without."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, state: Optional[Dict] = None):
        self.params, self.lr = params, lr
        state = state or {}
        self.m = {k: state["m"][k].clone() if state else torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: state["v"][k].clone() if state else torch.zeros_like(v) for k, v in params.items()}
        self.t = {k: state["t"][k] if state else 0 for k in params}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]):
        for k, p in self.params.items():
            self.t[k] += 1
            c1, c2 = 1 - BETA1 ** self.t[k], 1 - BETA2 ** self.t[k]
            g = grads[k]
            self.m[k].mul_(BETA1).add_(g, alpha=1 - BETA1)
            self.v[k].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
            p.sub_(self.lr * (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + EPS))


def run_steps(params: Dict[str, torch.Tensor], trainable: List[str], batches,
              logits_fn: Callable, pos_weight: float, lr: float, state: Optional[Dict] = None):
    """Train ``params`` in place over ``batches`` of (features, labels),
    from Adam's ``state`` where given. Returns (losses, first-step
    gradients)."""
    for k in trainable:
        params[k].requires_grad_(True)
    opt = Adam({k: params[k] for k in trainable}, lr, state)
    losses, first = [], None
    for x, y in batches:
        loss = weighted_bce_logits(y, logits_fn(params, x), pos_weight)
        grads = torch.autograd.grad(loss, [params[k] for k in trainable])
        grads = dict(zip(trainable, grads))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(grads)
        losses.append(float(loss.detach()))
    for k in trainable:
        params[k].requires_grad_(False)
    return losses, first

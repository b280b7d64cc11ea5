"""Data-parallel training over a process-group mesh.

Port of ``satellite_computervision_tpu/parallel/data_parallel.py``:
parameters replicated, each rank trains on its slice of the global batch
(``mesh.shard_batch``), gradients averaged over the mesh's data axis
(``DistributedDataParallel``).

BatchNorm. JAX's jitted step sees the global batch, so its BatchNorm
normalizes with global-batch statistics; DDP alone would normalize each
rank's slice by its own. :func:`shard_train_state` turns every BatchNorm
into a :class:`GlobalBatchNorm`, which all-reduces the per-channel sum,
sum of squares and count (differentiably) and normalizes as flax does
(one-pass variance ``E[x²] - E[x]²``). ``nn.SyncBatchNorm`` would do the
reduction on CUDA only; this one runs on gloo and NCCL alike.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.nn.parallel import DistributedDataParallel

from satellite_computervision_tpu_torch.models.blocks import BatchNorm
from satellite_computervision_tpu_torch.parallel.mesh import axis_size, mesh_device
from satellite_computervision_tpu_torch.train.checkpoint import unwrap
from satellite_computervision_tpu_torch.train.trainer import (
    TrainState,
    make_eval_step,
    make_train_step,
)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of ``group``; the gradient is summed likewise,
    so each rank's inputs receive every rank's loss gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class GlobalBatchNorm(BatchNorm):
    """:class:`~satellite_computervision_tpu_torch.models.blocks.BatchNorm`
    whose training-mode statistics are those of the global batch over the
    process group ``group``: the per-channel sum, sum of squares and
    element count are all-reduced, the mean and the biased variance
    ``max(E[x²] - E[x]², 0)`` taken from them in float32, and the running
    statistics updated with them as flax does. In eval mode it is a plain
    BatchNorm."""

    group = None

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        c = x.shape[1]
        xf = x.float()
        dims = (0, 2, 3)
        count = torch.full((1,), x.numel() // c, dtype=torch.float32, device=x.device)
        stats = _AllReduceSum.apply(
            torch.cat([xf.sum(dims), xf.square().sum(dims), count]), self.group)
        n = stats[-1]
        mean = stats[:c] / n
        var = torch.clamp(stats[c : 2 * c] / n - mean.square(), min=0.0)
        scale = torch.rsqrt(var + self.eps) * self.weight
        out = (xf - mean[None, :, None, None]) * scale[None, :, None, None] \
            + self.bias[None, :, None, None]
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(m * mean)
            self.running_var.mul_(1.0 - m).add_(m * var)
        return out.to(x.dtype)


def use_global_batchnorm(model: nn.Module, group) -> nn.Module:
    """Turn every BatchNorm of ``model`` into a :class:`GlobalBatchNorm`
    over ``group``, in place: the module keeps its parameters and buffers
    (an optimizer built over them still holds them) and its
    ``state_dict`` keys."""
    for mod in model.modules():
        if isinstance(mod, nn.BatchNorm2d):
            mod.__class__ = GlobalBatchNorm
            mod.group = group
    return model


def shard_train_state(state: TrainState, mesh, data_axis: str = "data") -> TrainState:
    """Replicate ``state`` over ``mesh``: the model on this rank's device
    with global-batch BatchNorm over the data axis, wrapped in
    ``DistributedDataParallel`` (which broadcasts rank 0's weights and
    buffers), in place; the optimizer keeps its parameters."""
    dev = mesh_device(mesh)
    group = mesh.get_group(data_axis)
    model = use_global_batchnorm(unwrap(state.model).to(dev), group)
    # the global BN keeps the running statistics equal on every rank
    state.model = DistributedDataParallel(
        model, device_ids=[dev] if dev.type == "cuda" else None, process_group=group,
        broadcast_buffers=False)
    return state


def _reduced(out, group, size):
    """The step's outputs over the group: the loss's mean over the ranks
    (equal slices: the global-batch mean), the confusion matrices' sum."""
    loss = out["loss"].detach().float().clone()
    cm = out["cm"].clone()
    dist.all_reduce(loss, group=group)
    dist.all_reduce(cm, group=group)
    return {"loss": loss / size, "cm": cm}


def make_parallel_train_step(loss_fn: Callable, mesh, pred_key: Optional[str] = "logits",
                             num_classes: int = 2, class_from: str = "classes",
                             data_axis: str = "data", compute_dtype=None) -> Callable:
    """``step(state, batch) -> {"loss", "cm"}`` over a state from
    :func:`shard_train_state`: ``batch`` is this rank's slice
    (``mesh.shard_batch``); the update is the global batch's (DDP averages
    the gradients), ``loss`` the global-batch mean and ``cm`` the global
    confusion matrix, the same on every rank."""
    group, size = mesh.get_group(data_axis), axis_size(mesh, data_axis)
    local = make_train_step(loss_fn, pred_key, num_classes=num_classes, class_from=class_from,
                            compute_dtype=compute_dtype)

    def step(state: TrainState, batch):
        return _reduced(local(state, batch), group, size)

    return step


def make_parallel_eval_step(loss_fn: Callable, mesh, pred_key: Optional[str] = "logits",
                            num_classes: int = 2, class_from: str = "classes",
                            data_axis: str = "data", compute_dtype=None) -> Callable:
    """The eval step over a sharded batch: each rank's slice through the
    running statistics, the loss averaged and the confusion matrices summed
    over the data axis."""
    group, size = mesh.get_group(data_axis), axis_size(mesh, data_axis)
    local = make_eval_step(loss_fn, pred_key, num_classes=num_classes, class_from=class_from,
                           compute_dtype=compute_dtype)

    def step(state: TrainState, batch):
        return _reduced(local(state, batch), group, size)

    return step

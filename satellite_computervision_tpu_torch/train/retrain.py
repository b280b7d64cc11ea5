"""Warm-start / continue-training flows.

Port of ``satellite_computervision_tpu/train/retrain.py``: load weights
(a local checkpoint directory or a flax msgpack blob by URL), optionally
rebuild the optimizer with a fresh learning rate and freeze every
top-level submodule but one, and evaluate to seed the best metric.

The port's top-level module names are the flax ones (``models/blocks.py``
header), so ``freeze_to="head"`` names the same subtree in both packages.
A frozen parameter gets no update, as ``optax.masked(set_to_zero)`` after
Adam gives it in JAX: the new Adam holds only the trainable parameters.
BatchNorm running statistics still move in training, as JAX's
``batch_stats`` do.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional

import torch

from satellite_computervision_tpu_torch.models.bridge import flax_to_torch
from satellite_computervision_tpu_torch.train.checkpoint import (
    keeping_own_flags,
    load_remote_weights,
    read_flax_checkpoint,
    unwrap,
)
from satellite_computervision_tpu_torch.train.trainer import Trainer, TrainState, adam


def freeze_mask(model: torch.nn.Module, trainable_names: Iterable[str]) -> Dict[str, bool]:
    """``{parameter name: frozen}``: True for every parameter under a
    top-level submodule not named in ``trainable_names``."""
    trainable = set(trainable_names)
    return {name: name.split(".")[0] not in trainable
            for name, _ in unwrap(model).named_parameters()}


def _restore(path: str, state: TrainState) -> None:
    """Load the checkpoint directory ``path`` into ``state`` in place: the
    port's ``model.pt`` (weights, optimizer state, step) or the JAX
    package's ``state.msgpack`` (weights and step)."""
    model = unwrap(state.model)
    pt = os.path.join(path, "model.pt")
    if os.path.exists(pt):
        blob = torch.load(pt, map_location="cpu", weights_only=True)
        model.load_state_dict(blob["state_dict"])
        if "optimizer" in blob:
            with keeping_own_flags(state.optimizer):
                state.optimizer.load_state_dict(blob["optimizer"])
        state.step = int(blob.get("step", blob["meta"].get("step", 0)))
    else:
        tree, _ = read_flax_checkpoint(path)
        # copied into the model's own tensors: the optimizer holds them
        model.load_state_dict(flax_to_torch(tree["params"], tree.get("batch_stats"), model))
        state.step = int(tree.get("step", 0))


def retrain(
    state: TrainState,
    loss_fn,
    checkpoint_path: Optional[str] = None,
    weights_url: Optional[str] = None,
    eval_iter=None,
    learning_rate: Optional[float] = None,
    freeze_to: Optional[str] = None,
    pred_key: str = "logits",
    num_classes: int = 2,
    monitor: str = "mean_iou",
    **trainer_kwargs,
) -> Trainer:
    """A :class:`Trainer` primed for continued training.

    - restore ``state`` from the checkpoint directory ``checkpoint_path``
      (:func:`_restore`) and/or
      the flax blob at ``weights_url``
      (``train/checkpoint.py::load_remote_weights``);
    - with ``learning_rate`` and/or ``freeze_to`` (e.g. ``"head"``), a new
      Adam (``trainer.adam``) at ``learning_rate`` (9e-4 when only ``freeze_to`` is given)
      over the parameters left trainable;
    - evaluate on ``eval_iter`` so the best metric starts at the restored
      model's.

    ``trainer_kwargs`` pass on to :class:`Trainer` (``compute_dtype``,
    ``checkpoint_manager``, ...)."""
    if checkpoint_path:
        _restore(checkpoint_path, state)
    if weights_url:
        load_remote_weights(weights_url, state.model)

    if learning_rate is not None or freeze_to is not None:
        frozen = freeze_mask(state.model, {freeze_to}) if freeze_to is not None else {}
        params = [p for name, p in unwrap(state.model).named_parameters()
                  if not frozen.get(name, False)]
        state.optimizer = adam(params, learning_rate if learning_rate is not None else 9e-4)

    trainer = Trainer(state, loss_fn, pred_key=pred_key, num_classes=num_classes,
                      monitor=monitor, **trainer_kwargs)
    if eval_iter is not None:
        trainer.seed_best_from_eval(eval_iter)
    return trainer

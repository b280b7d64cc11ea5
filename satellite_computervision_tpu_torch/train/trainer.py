"""Training with BatchNorm state, metrics and best-metric checkpoints.

Port of ``satellite_computervision_tpu/train/trainer.py``:

- ``TrainState`` = the model (parameters and BatchNorm buffers), its
  optimizer and the step count;
- a train step is forward in train mode, loss, backward, the optimizer
  update (BN running statistics update in the forward) and the step's
  confusion matrix from the ``classes`` head against ``y > 0.5`` (or the
  argmax of one-hot labels); a multi-input family (the Siamese model's
  before/after) passes ``x`` as a tuple or list of its positional inputs,
  and a tuple or list ``y`` (multi-head targets) gets no confusion matrix;
- loss and confusion matrix are summed on the device: one host sync per
  epoch or evaluation, not per step;
- a train step is a ``train.step`` span (``utils.profiling.span``,
  recorded only while a ``torch.profiler`` session runs; ``step`` is the
  state's step count) holding ``train.forward`` (forward and loss),
  ``train.backward``, ``train.optimizer`` (``zero_grad`` before the
  backward, the update after it) and ``train.metrics``.

The optimizer is ``torch.optim.Adam`` with optax's defaults (betas
0.9/0.999, eps 1e-8 added outside the square root, no weight decay). On
CUDA, ``compute_dtype=torch.bfloat16`` runs the forward under
``torch.autocast`` over float32 parameters, as the JAX model's ``dtype``
does; the loss is taken on float32 logits.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional

import torch

from satellite_computervision_tpu_torch.models import metrics as metrics_lib
from satellite_computervision_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(model: torch.nn.Module, learning_rate: float = 9e-4,
                       optimizer: Optional[torch.optim.Optimizer] = None) -> TrainState:
    """Wrap a model with Adam at ``learning_rate`` (the solar notebook's
    optimizer) unless an optimizer is given."""
    if optimizer is None:
        optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate,
                                     betas=(0.9, 0.999), eps=1e-8)
    return TrainState(model=model, optimizer=optimizer)


def _autocast(x: torch.Tensor, compute_dtype):
    if compute_dtype is None or compute_dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(x.device.type, dtype=compute_dtype)


def _labels_int(y: torch.Tensor) -> torch.Tensor:
    return torch.argmax(y, -1) if y.shape[-1] > 1 else (y[..., 0] > 0.5)


def _inputs(x) -> tuple:
    """The model's positional inputs: ``x`` itself, or the items of a tuple
    or list ``x`` (multi-input families)."""
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _confusion(out, y, class_from, num_classes, device):
    if isinstance(out, dict) and class_from in out and not isinstance(y, (tuple, list)):
        return metrics_lib.confusion_matrix(_labels_int(y), out[class_from], num_classes)
    return metrics_lib.init_metric_state(num_classes, device)


def make_train_step(loss_fn: Callable, pred_key: Optional[str] = "logits",
                    num_classes: int = 2, class_from: str = "classes",
                    compute_dtype=None) -> Callable:
    """``step(state, (x, y)) -> {"loss", "cm"}`` (device tensors); updates
    ``state`` in place. ``loss_fn(y_true, y_pred)`` takes
    ``out[pred_key]`` (the whole output dict when ``pred_key`` is None)."""

    def step(state: TrainState, batch):
        with span("train.step", step=state.step):
            return _step(state, batch)

    def _step(state: TrainState, batch):
        x, y = batch
        inputs = _inputs(x)
        model = state.model
        model.train()
        with span("train.forward"):
            with _autocast(inputs[0], compute_dtype):
                out = model(*inputs)
            preds = out[pred_key] if isinstance(out, dict) and pred_key else out
            loss = loss_fn(y, preds)
        with span("train.optimizer"):
            state.optimizer.zero_grad(set_to_none=True)
        with span("train.backward"):
            loss.backward()
        with span("train.optimizer"):
            state.optimizer.step()
        state.step += 1
        with span("train.metrics"):
            cm = _confusion(out, y, class_from, num_classes, inputs[0].device)
        return {"loss": loss.detach(), "cm": cm}

    return step


def make_eval_step(loss_fn: Callable, pred_key: Optional[str] = "logits",
                   num_classes: int = 2, class_from: str = "classes",
                   compute_dtype=None) -> Callable:
    """``step(state, (x, y)) -> {"loss", "cm"}``: forward with the running
    BN statistics, no gradient."""

    def step(state: TrainState, batch):
        x, y = batch
        inputs = _inputs(x)
        model = state.model
        model.eval()
        with torch.no_grad(), _autocast(inputs[0], compute_dtype):
            out = model(*inputs)
        preds = out[pred_key] if isinstance(out, dict) and pred_key else out
        with torch.no_grad():
            loss = loss_fn(y, preds)
        if isinstance(y, (tuple, list)):
            cm = metrics_lib.init_metric_state(num_classes, inputs[0].device)
        else:
            y_hat = out[class_from] if isinstance(out, dict) and class_from in out else preds
            cm = metrics_lib.confusion_matrix(_labels_int(y), y_hat, num_classes)
        return {"loss": loss, "cm": cm}

    return step


class Trainer:
    """Epoch loop with best-metric checkpointing and resume.

    Each epoch runs ``steps_per_epoch`` train steps, then (when an eval
    stream exists) an evaluation; when the monitored metric improves, the
    state is checkpointed (ModelCheckpoint ``save_best_only``). Resume
    re-seeds the best metric from a fresh evaluation
    (:meth:`seed_best_from_eval`)."""

    def __init__(self, state: TrainState, loss_fn: Callable, pred_key: Optional[str] = "logits",
                 num_classes: int = 2, monitor: str = "mean_iou", mode: str = "max",
                 checkpoint_manager=None, compute_dtype=None):
        self.state = state
        self.train_step = make_train_step(loss_fn, pred_key, num_classes=num_classes,
                                          compute_dtype=compute_dtype)
        self.eval_step = make_eval_step(loss_fn, pred_key, num_classes=num_classes,
                                        compute_dtype=compute_dtype)
        self.num_classes = num_classes
        self.monitor = monitor
        self.mode = mode
        self.ckpt = checkpoint_manager
        self.best = float("-inf") if mode == "max" else float("inf")
        self.history: list = []

    def _improved(self, value: float) -> bool:
        return value > self.best if self.mode == "max" else value < self.best

    def _finalize(self, cm, total_loss, n) -> Dict[str, float]:
        result = {k: float(v) for k, v in metrics_lib.finalize_metrics(cm).items()}
        result["loss"] = float(total_loss) / n if n else 0.0
        return result

    def evaluate(self, eval_iter) -> Dict[str, float]:
        cm, total_loss, n = None, None, 0
        for batch in eval_iter:
            out = self.eval_step(self.state, batch)
            cm = out["cm"] if cm is None else cm + out["cm"]
            total_loss = out["loss"] if total_loss is None else total_loss + out["loss"]
            n += 1
        if cm is None:
            cm = metrics_lib.init_metric_state(self.num_classes)
        return self._finalize(cm, total_loss, n)

    def seed_best_from_eval(self, eval_iter) -> Dict[str, float]:
        """Resume: evaluate the restored model and take that as the
        checkpoint-best baseline."""
        result = self.evaluate(eval_iter)
        self.best = result[self.monitor]
        return result

    def fit(self, train_iter, epochs: int, steps_per_epoch: int,
            eval_fn: Optional[Callable] = None, log_fn: Callable = print):
        train_it = iter(train_iter)
        for epoch in range(epochs):
            cm, running_loss = None, None
            for _ in range(steps_per_epoch):
                out = self.train_step(self.state, next(train_it))
                cm = out["cm"] if cm is None else cm + out["cm"]
                running_loss = out["loss"] if running_loss is None else running_loss + out["loss"]
            record = {"epoch": epoch, "train": self._finalize(cm, running_loss, steps_per_epoch)}
            # checkpoint-best on eval metrics when an eval stream exists,
            # else on train metrics
            if eval_fn is not None:
                record["val"] = self.evaluate(eval_fn())
                monitored = record["val"]
            else:
                monitored = record["train"]
            value = monitored.get(self.monitor)
            if value is not None and self._improved(value):
                self.best = value
                if self.ckpt is not None:
                    self.ckpt.save(self.state, step=self.state.step, metrics=monitored)
                record["checkpointed"] = True
            self.history.append(record)
            log_fn(record)
        return self.history

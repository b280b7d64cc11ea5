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
  state's step count, ``graphed`` whether a CUDA graph ran it) holding
  ``train.forward`` (forward and loss), ``train.backward``,
  ``train.optimizer`` (``zero_grad`` before the backward, the update after
  it) and ``train.metrics``; a replayed step has none of these inside it:
  they were recorded once, in the step that captured the graph.

The optimizer is ``torch.optim.Adam`` with optax's defaults (betas
0.9/0.999, eps 1e-8 added outside the square root, no weight decay),
``capturable`` and ``fused`` where the parameters are on CUDA. On CUDA,
``compute_dtype=torch.bfloat16`` runs the forward under ``torch.autocast``
over float32 parameters, as the JAX model's ``dtype`` does; the loss is
taken on float32 logits.

CUDA graphs. A step that launches its kernels one at a time from Python
leaves the card idle while the host catches up, so the train step replays
a CUDA graph of itself where it can (:class:`_StepGraph`): the forward,
loss, ``zero_grad``, backward, Adam update, BatchNorm's running statistics
and the confusion matrix, over static copies of the batch. The same
kernels run on the same data; the step copies each new batch into the
graph's inputs, replays, and returns copies of its loss and confusion
matrix. It takes a graph only where it can see that one is sound
(:func:`_graphable`): CUDA inputs, a ``capturable`` optimizer, a model not
wrapped for data parallelism and holding no ``GlobalBatchNorm``, no
``torch`` dispatch or function mode active (``FlopCounterMode`` counts an
eager step), and an input signature (structure, shapes, dtypes, strides,
device) seen in :data:`EAGER_STEPS` eager steps in a row before. Those
steps are real ones, and create Adam's state and do cuDNN's and cuBLAS's
first-call work; the next step is captured and its first replay does its
work. Autocast keeps no weight cache inside the capture, so each replay
casts the current weights. A capture that fails (an op that reads the
device back, a collective) leaves the state as it was, runs the step
eagerly and is not tried again for that signature. A graph is dropped when
its parameters move (``.to()``) or the optimizer's state or
hyperparameters change; the step keeps at most :data:`MAX_GRAPHS`. The
step function counts ``captures``, ``replays`` (the capturing step's
first replay included) and ``eager`` steps.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from collections import OrderedDict
from typing import Callable, Dict, Optional

import torch

from satellite_computervision_tpu_torch.models import metrics as metrics_lib
from satellite_computervision_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


EAGER_STEPS = 2  # eager steps of an input signature, in a row, before its capture
MAX_GRAPHS = 4  # captured steps kept by one step function, the least recently used dropped


def adam(params, learning_rate: float) -> torch.optim.Adam:
    """The trainer's Adam: optax's defaults; where every parameter is on
    CUDA, ``capturable`` (its step count on the device, so a CUDA graph
    can hold the update) and ``fused`` (one kernel over all parameters in
    place of a chain of multi-tensor ones: 1.2 ms an update of the 40 M
    DeepLab parameters on an H100, against 6.5 ms)."""
    params = list(params)
    on_cuda = bool(params) and all(p.device.type == "cuda" for p in params)
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            capturable=on_cuda, fused=on_cuda or None)


def create_train_state(model: torch.nn.Module, learning_rate: float = 9e-4,
                       optimizer: Optional[torch.optim.Optimizer] = None) -> TrainState:
    """Wrap a model with :func:`adam` at ``learning_rate`` (the solar
    notebook's optimizer) unless an optimizer is given."""
    if optimizer is None:
        optimizer = adam(model.parameters(), learning_rate)
    return TrainState(model=model, optimizer=optimizer)


def _autocast(x: torch.Tensor, compute_dtype, cache: bool = True):
    if compute_dtype is None or compute_dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(x.device.type, dtype=compute_dtype, cache_enabled=cache)


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


def _seq(v) -> list:
    return list(v) if isinstance(v, (tuple, list)) else [v]


def _leaves(batch) -> list:
    """The items of ``(x, y)``: ``x`` and ``y`` each a tensor or a tuple
    or list of them."""
    x, y = batch
    return _seq(x) + _seq(y)


def _like(batch, leaves) -> tuple:
    """``(x, y)`` of ``batch``'s structure over ``leaves`` (tuples where
    it had tuples or lists)."""
    it = iter(leaves)

    def take(v):
        return tuple(next(it) for _ in v) if isinstance(v, (tuple, list)) else next(it)

    x, y = batch
    return take(x), take(y)


def _signature(state: TrainState, batch) -> tuple:
    """What a captured step is keyed by: the state's model and optimizer,
    the batch's structure and each tensor's shape, dtype, strides and
    device."""
    x, y = batch
    shape = tuple(len(v) if isinstance(v, (tuple, list)) else -1 for v in (x, y))
    return (id(state.model), id(state.optimizer), shape,
            tuple((t.shape, t.dtype, t.stride(), t.device) for t in _leaves(batch)))


def _graphable(state: TrainState, batch) -> bool:
    """Whether a step of ``state`` over ``batch`` may run as a CUDA graph,
    from what the step can see: every input a CUDA tensor of one device,
    every parameter group of the optimizer ``capturable``, the model not
    wrapped for data parallelism, gradients on, no ``torch`` dispatch or
    function mode (``FlopCounterMode``, a device context) active, and no
    capture already running."""
    from torch.nn.parallel import DataParallel, DistributedDataParallel

    leaves = _leaves(batch)
    device = leaves[0].device if isinstance(leaves[0], torch.Tensor) else None
    return (device is not None and device.type == "cuda"
            and all(isinstance(t, torch.Tensor) and t.device == device for t in leaves)
            and all(g.get("capturable", False) for g in state.optimizer.param_groups)
            and not isinstance(state.model, (DataParallel, DistributedDataParallel))
            and torch.is_grad_enabled()
            and torch._C._len_torch_dispatch_stack() == 0
            and torch._C._len_torch_function_stack() == 0
            and not torch.cuda.is_current_stream_capturing())


def _collective(model: torch.nn.Module) -> bool:
    """Whether the model holds a module that talks to other processes
    (data parallelism's ``GlobalBatchNorm``): its step stays eager."""
    from satellite_computervision_tpu_torch.parallel.data_parallel import GlobalBatchNorm

    return any(isinstance(m, GlobalBatchNorm) for m in model.modules())


def _hyperparameters(optimizer: torch.optim.Optimizer) -> list:
    """The optimizer's scalar settings by group (learning rate, betas ...):
    a capture bakes them into its kernels' arguments."""
    return [sorted((k, v) for k, v in g.items()
                   if k != "params" and isinstance(v, (bool, int, float, str, tuple, type(None))))
            for g in optimizer.param_groups]


def _after_failed_capture(device: torch.device, stream, pool) -> None:
    """Put back what a capture that ended in an error leaves behind: its
    side stream current, the allocator still sending allocations to its
    memory pool (memory used across streams then is never freed), and the
    CUDA generator in capture mode (every later random op then raises)."""
    torch.cuda.set_stream(stream)
    with contextlib.suppress(RuntimeError):  # already ended where the error came later
        torch._C._cuda_endAllocateToPool(device.index, pool)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the graph below is empty, by design
        with torch.cuda.device(device), \
                torch.cuda.graph(torch.cuda.CUDAGraph(), capture_error_mode="thread_local"):
            pass  # a capture that ends cleanly takes the generator out of capture mode


class _StepGraph:
    """One train step captured as a CUDA graph over static copies of a
    batch. The graph writes the parameters, Adam's moments and step count
    and BatchNorm's buffers in place, and its loss and confusion matrix
    into static outputs; the gradients live in its private memory pool."""

    def __init__(self, state: TrainState, batch):
        # both held: the signature keys the graph by their ids
        self.model, self.optimizer = state.model, state.optimizer
        self.params = [p for g in state.optimizer.param_groups for p in g["params"]]
        self.opt_state = state.optimizer.state  # held: the fingerprint compares its id
        self.fingerprint = self._fingerprint()
        self.leaves = [torch.empty_like(t) for t in _leaves(batch)]
        self.batch = _like(batch, self.leaves)
        self.graph = torch.cuda.CUDAGraph()
        self.out = None

    def _fingerprint(self) -> tuple:
        return ([(p.data_ptr(), p.requires_grad) for p in self.params],
                _hyperparameters(self.optimizer), id(self.optimizer.state))

    def current(self) -> bool:
        """Whether the graph still addresses the state's tensors with its
        settings (a ``.to()`` of the model, a loaded optimizer state or a
        new learning rate end it)."""
        return self._fingerprint() == self.fingerprint

    def capture(self, run: Callable, state: TrainState) -> bool:
        """Capture ``run(state, batch)`` over the static batch. Nothing
        captured runs; on failure the host-side state the capture touched
        (gradients, Adam's per-parameter state) is put back and False
        returned."""
        grads = [p.grad for p in self.params]
        opt_state = {p: dict(s) for p, s in self.optimizer.state.items()}
        device = self.leaves[0].device
        stream = torch.cuda.current_stream(device)
        pool = torch.cuda.graph_pool_handle()
        captured = False
        try:
            with torch.cuda.device(device), \
                    torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
                self.out = run(state, self.batch, cache=False)
            captured = True
        except RuntimeError as e:
            warnings.warn(f"the train step could not be captured as a CUDA graph ({e}); "
                          "it runs eagerly for this input signature", RuntimeWarning)
        finally:
            if not captured:
                _after_failed_capture(device, stream, pool)
                for p, g in zip(self.params, grads):
                    p.grad = g
                self.optimizer.state.clear()
                self.optimizer.state.update(opt_state)
                self.graph = self.out = None
        return captured

    def replay(self, batch) -> Dict[str, torch.Tensor]:
        """Copy ``batch`` into the static inputs, replay, and return copies
        of the loss and confusion matrix, which the next replay
        overwrites."""
        for static, t in zip(self.leaves, _leaves(batch)):
            static.copy_(t)
        self.graph.replay()
        return {k: v.clone() for k, v in self.out.items()}


class _GraphCache:
    """A step function's captured steps by signature, and which signature
    it saw last and how many times in a row."""

    def __init__(self):
        self.graphs: "OrderedDict[tuple, Optional[_StepGraph]]" = OrderedDict()  # None: failed
        self.last, self.row = None, 0

    def lookup(self, state: TrainState, batch) -> Optional[_StepGraph]:
        """The graph this step replays (captured, or to capture now), or
        None for an eager step; counts the step toward its signature's
        capture."""
        if not _graphable(state, batch):
            return None
        key = _signature(state, batch)
        if key in self.graphs:
            graph = self.graphs[key]
            if graph is None:
                return None
            if graph.current():
                self.graphs.move_to_end(key)
                return graph
            del self.graphs[key]
            self.last = None
        self.row = self.row + 1 if key == self.last else 1
        self.last = key
        if self.row <= EAGER_STEPS:
            return None
        if _collective(state.model):
            self.graphs[key] = None
            return None
        graph = self.graphs[key] = _StepGraph(state, batch)
        while len(self.graphs) > MAX_GRAPHS:
            self.graphs.popitem(last=False)
        return graph

    def failed(self, state: TrainState, batch) -> None:
        """Its capture failed: the signature's steps stay eager."""
        self.graphs[_signature(state, batch)] = None


def make_train_step(loss_fn: Callable, pred_key: Optional[str] = "logits",
                    num_classes: int = 2, class_from: str = "classes",
                    compute_dtype=None) -> Callable:
    """``step(state, (x, y)) -> {"loss", "cm"}`` (device tensors); updates
    ``state`` in place. ``loss_fn(y_true, y_pred)`` takes
    ``out[pred_key]`` (the whole output dict when ``pred_key`` is None).
    On CUDA the step replays a CUDA graph of itself where it can (module
    docstring); ``step.captures``, ``step.replays`` and ``step.eager``
    count what ran."""
    graphs = _GraphCache()

    def run(state: TrainState, batch, cache: bool = True):
        x, y = batch
        inputs = _inputs(x)
        model = state.model
        model.train()
        with span("train.forward"):
            with _autocast(inputs[0], compute_dtype, cache):
                out = model(*inputs)
            preds = out[pred_key] if isinstance(out, dict) and pred_key else out
            loss = loss_fn(y, preds)
        with span("train.optimizer"):
            state.optimizer.zero_grad(set_to_none=True)
        with span("train.backward"):
            loss.backward()
        with span("train.optimizer"):
            state.optimizer.step()
        with span("train.metrics"):
            cm = _confusion(out, y, class_from, num_classes, inputs[0].device)
        return {"loss": loss.detach(), "cm": cm}

    def step(state: TrainState, batch):
        graph = graphs.lookup(state, batch)
        with span("train.step", step=state.step, graphed=graph is not None) as s:
            if graph is not None and graph.out is None:
                if graph.capture(run, state):
                    step.captures += 1
                else:
                    graphs.failed(state, batch)
                    graph = None
                    s.set(graphed=False)
            if graph is None:
                out = run(state, batch)
                step.eager += 1
            else:
                out = graph.replay(batch)
                step.replays += 1
        state.step += 1
        return out

    step.captures = step.replays = step.eager = 0
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

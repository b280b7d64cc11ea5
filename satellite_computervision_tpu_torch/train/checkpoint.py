"""The port's checkpoint format and the best/latest checkpoint manager.

A checkpoint is one file ``<dir>/<which>/model.pt`` (``which`` is
``best`` or ``latest``, as the JAX package's ``<dir>/best``): one
``torch.save`` of ``{"arch", "model_kwargs", "state_dict", "meta"}`` plus,
when a training state is saved, ``"optimizer"`` (the optimizer's
``state_dict``) and ``"step"``. ``arch`` names the model class, the zoo's
family name (:data:`ARCHS`); a file without it (written before the
Siamese model was ported) holds a ``UNet``. ``model_kwargs``
are the constructor arguments (the model's ``kwargs``); ``meta`` is a
JSON-able dict ``{"step", "metrics"}``. ``predict.load_model`` reads
``<dir>/best``.

The JAX package's msgpack checkpoints (``<dir>/state.msgpack`` from
``flax.serialization.to_bytes`` plus ``meta.json``) are read by
:func:`read_flax_checkpoint` through the port's own decoder
(``train/flax_msgpack.py``; no ``msgpack``, ``flax`` or ``jax`` import),
and :func:`load_flax_weights` puts their ``params``/``batch_stats`` into a
model of the port with ``models.bridge.flax_to_torch``; ``opt_state`` is decoded
but not used; :func:`load_remote_weights` fetches such a blob by URL.

``CheckpointManager(root, backend="dcp")`` is the sharded-state backend
(the JAX package's orbax one): ``<root>/<which>/`` holds a
``torch.distributed.checkpoint`` of the model and optimizer state, which
every rank of a process group writes together, and ``scv_meta.json``
``{"step", "metrics"}``, which rank 0 writes. It does not read a JAX
orbax directory: that needs orbax, which imports JAX.

Both backends restore an optimizer under :func:`keeping_own_flags`: a
CUDA state's Adam is ``capturable`` and ``fused`` (``train/trainer.py``),
and a checkpoint of a CPU Adam, or of one written before the step was
graphed, loads into it and leaves it so.
"""

from __future__ import annotations

import contextlib
import json
import os
import urllib.request
from typing import Any, Dict, Optional, Tuple, Union

import torch

from satellite_computervision_tpu_torch.models.acnn import ACNN, HierarchicalACNN
from satellite_computervision_tpu_torch.models.bridge import flax_to_torch, torch_to_flax
from satellite_computervision_tpu_torch.models.convlstm import LSTMAutoencoder, LSTMModel
from satellite_computervision_tpu_torch.models.deeplab import DeepLabV3Plus
from satellite_computervision_tpu_torch.models.hybrid import HybridUNetLSTM
from satellite_computervision_tpu_torch.models.prithvi import PrithviSegmenter
from satellite_computervision_tpu_torch.models.satlas import SatlasSwinSegmenter
from satellite_computervision_tpu_torch.models.siamese import SiameseUNet
from satellite_computervision_tpu_torch.models.unet import UNet
from satellite_computervision_tpu_torch.train import flax_msgpack

Model = Union[UNet, SiameseUNet, DeepLabV3Plus, LSTMModel, LSTMAutoencoder, HybridUNetLSTM,
              ACNN, HierarchicalACNN, PrithviSegmenter, SatlasSwinSegmenter]
ARCHS = {"unet": UNet, "siamese": SiameseUNet, "deeplab": DeepLabV3Plus,
         "convlstm": LSTMModel, "lstm_autoencoder": LSTMAutoencoder, "hybrid": HybridUNetLSTM,
         "acnn": ACNN, "hierarchical": HierarchicalACNN, "prithvi": PrithviSegmenter,
         "satlas": SatlasSwinSegmenter}


def build_empty(build, *args, **kwargs) -> Model:
    """``build(*args, **kwargs)`` on the meta device: no initial weights are
    drawn (seconds on the CPU for a ResNet-50 DeepLab); the weights come
    next from ``load_state_dict(..., assign=True)``."""
    with torch.device("meta"):
        return build(*args, **kwargs)


def unwrap(model: torch.nn.Module) -> torch.nn.Module:
    """The model inside a ``DistributedDataParallel`` wrapper (itself
    otherwise)."""
    return getattr(model, "module", model)


def arch_of(model: Model) -> str:
    """The ``arch`` name of a model of the port (:data:`ARCHS`)."""
    for name, cls in ARCHS.items():
        if isinstance(model, cls):
            return name
    raise TypeError(f"no checkpoint arch for {type(model).__name__}")


def _file(path: str, which: str) -> str:
    return os.path.join(path, which, "model.pt")


def save_checkpoint(path: str, model: Model, meta: Optional[Dict] = None, which: str = "best",
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    step: Optional[int] = None) -> str:
    """Write ``model`` (weights as float32 on the CPU), and the optimizer
    state and step when given, to ``path/<which>/model.pt``; returns the
    file path. The file is written whole, then renamed into place."""
    out = _file(path, which)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    model = unwrap(model)
    state = {k: (v.detach().float() if v.is_floating_point() else v.detach()).cpu()
             for k, v in model.state_dict().items()}
    blob = {"arch": arch_of(model), "model_kwargs": dict(model.kwargs), "state_dict": state,
            "meta": dict(meta or {})}
    if optimizer is not None:
        blob["optimizer"] = optimizer.state_dict()
    if step is not None:
        blob["step"] = int(step)
    torch.save(blob, out + ".tmp")
    os.replace(out + ".tmp", out)
    return out


def _read(path: str, which: str) -> Dict:
    return torch.load(_file(path, which), map_location="cpu", weights_only=True)


def load_checkpoint(path: str, which: str = "best", **overrides) -> Tuple[Model, Dict]:
    """Rebuild the model saved at ``path/<which>/model.pt`` (its ``arch``,
    ``UNet`` when the file names none; float32, CPU, eval mode) and return
    ``(model, meta)``. ``overrides`` replace saved constructor arguments;
    a mismatching weight layout raises."""
    blob = _read(path, which)
    model = build_empty(ARCHS[blob.get("arch", "unet")], **{**blob["model_kwargs"], **overrides})
    model.load_state_dict(blob["state_dict"], assign=True)
    return model.eval(), blob["meta"]


def read_flax_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict]:
    """``(state tree, meta)`` of a JAX-package checkpoint directory
    ``path`` (``state.msgpack`` + ``meta.json``, as its
    ``train/checkpoint.py::save_checkpoint`` writes them). The tree holds
    ``step``, ``params``, ``batch_stats`` and ``opt_state`` as numpy
    arrays; ``meta`` is ``{}`` without ``meta.json``."""
    with open(os.path.join(path, "state.msgpack"), "rb") as f:
        tree = flax_msgpack.restore(f.read())
    meta = {}
    meta_path = os.path.join(path, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return tree, meta


def load_flax_weights(model: Model, tree: Dict[str, Any]) -> Model:
    """Load a flax state tree's ``params``/``batch_stats`` into ``model``
    (eval mode; ``model`` may be a :func:`build_empty` one). A tree of
    another architecture raises ``KeyError`` (a missing or unused leaf) or
    ``RuntimeError`` (a shape mismatch)."""
    model.load_state_dict(flax_to_torch(tree["params"], tree.get("batch_stats"), model),
                          assign=True)
    return model.eval()


def load_remote_weights(url: str, model: Model) -> Model:
    """Fetch a flax msgpack blob by URL (``https://``, or ``file://``) and
    load it into ``model`` in place: a state tree with ``params`` (and
    ``batch_stats``), or a bare ``params`` tree, as the JAX package's
    ``load_remote_weights`` takes it, which keeps the model's BatchNorm
    running statistics. Decoded by ``train/flax_msgpack.py`` and bridged by
    ``models.bridge.flax_to_torch``."""
    with urllib.request.urlopen(url) as resp:
        tree = flax_msgpack.restore(resp.read())
    inner = unwrap(model)
    if "params" in tree:
        params, stats = tree["params"], tree.get("batch_stats")
    else:
        params, stats = tree, torch_to_flax(inner)[1]
    state = flax_to_torch(params, stats, inner)
    with torch.no_grad():
        for key, value in inner.state_dict().items():
            if not key.endswith("num_batches_tracked"):  # flax keeps no such counter
                value.copy_(state[key])
    return model


_OWN_FLAGS = ("capturable", "fused")  # how an optimizer runs, not what it computes


@contextlib.contextmanager
def keeping_own_flags(optimizer: torch.optim.Optimizer):
    """Load an optimizer state inside: each parameter group keeps its own
    ``capturable`` and ``fused`` flags (``load_state_dict`` takes the
    writer's), and each step count moves where they keep it: the
    parameter's device when capturable or fused, else the CPU."""
    flags = [{k: g[k] for k in _OWN_FLAGS if k in g} for g in optimizer.param_groups]
    yield
    for group, own in zip(optimizer.param_groups, flags):
        group.update(own)
        on_device = group.get("capturable") or group.get("fused")
        for p in group["params"]:
            state = optimizer.state.get(p, {})
            if isinstance(state.get("step"), torch.Tensor):
                state["step"] = state["step"].to(p.device if on_device else "cpu")


def _dcp_state(state) -> Dict[str, Any]:
    from torch.distributed.checkpoint.state_dict import get_state_dict

    model_sd, optim_sd = get_state_dict(state.model, state.optimizer)
    return {"model": model_sd, "optimizer": optim_sd}


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def save_checkpoint_dcp(path: str, state, metrics: Optional[Dict[str, float]] = None,
                        step: int = 0) -> str:
    """Write ``state``'s model (a ``DistributedDataParallel`` one too) and
    optimizer with ``torch.distributed.checkpoint`` to the directory
    ``path``: every rank of the process group takes part; rank 0 alone
    writes ``scv_meta.json``. Without a process group it writes alone."""
    import torch.distributed.checkpoint as dcp

    os.makedirs(path, exist_ok=True)
    dcp.save(_dcp_state(state), checkpoint_id=path)
    if _rank() == 0:
        with open(os.path.join(path, "scv_meta.json"), "w") as f:
            json.dump({"step": int(step), "metrics": metrics or {}}, f)
    return path


def load_checkpoint_dcp(path: str, state) -> Tuple[Any, Dict]:
    """Restore a :func:`save_checkpoint_dcp` directory into ``state`` in
    place (weights, BatchNorm buffers, optimizer state, step) and return
    ``(state, meta)``. Rank 0 reads the meta and, under a process group of
    more than one rank, broadcasts it, so ranks without a shared file
    system restore the same step and metrics."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.state_dict import set_state_dict

    target = _dcp_state(state)
    dcp.load(target, checkpoint_id=path)
    with keeping_own_flags(state.optimizer):
        set_state_dict(state.model, state.optimizer, model_state_dict=target["model"],
                       optim_state_dict=target["optimizer"])
    meta: Dict[str, Any] = {}
    meta_path = os.path.join(path, "scv_meta.json")
    if _rank() == 0 and os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        box = [meta]
        dist.broadcast_object_list(box, src=0)
        meta = box[0]
    state.step = int(meta.get("step", 0))
    return state, meta


class CheckpointManager:
    """Keeps the ``best`` and ``latest`` training checkpoints under
    ``root``: ``backend="pt"`` one ``model.pt`` each (what ``predict`` and
    ``evaluate`` serve), ``backend="dcp"`` a ``torch.distributed.checkpoint``
    directory each, written by every rank (:func:`save_checkpoint_dcp`).
    :meth:`save` writes ``best`` and, with ``keep_latest`` (the default),
    ``latest``; :meth:`save_latest` writes ``latest`` alone."""

    def __init__(self, root: str, keep_latest: bool = True, backend: str = "pt"):
        if backend not in ("pt", "dcp"):
            raise ValueError(f"unknown checkpoint backend {backend!r}")
        self.root = root
        self.keep_latest = keep_latest
        self.backend = backend
        os.makedirs(root, exist_ok=True)

    def _save(self, which: str, state, step: int, metrics: Optional[Dict[str, float]]):
        if self.backend == "dcp":
            save_checkpoint_dcp(os.path.join(self.root, which), state, metrics, step)
        else:
            save_checkpoint(self.root, state.model, {"step": int(step), "metrics": metrics or {}},
                            which=which, optimizer=state.optimizer, step=step)

    def save(self, state, step: int, metrics: Optional[Dict[str, float]] = None):
        self._save("best", state, step, metrics)
        if self.keep_latest:
            self._save("latest", state, step, metrics)

    def save_latest(self, state, step: int, metrics: Optional[Dict[str, float]] = None):
        self._save("latest", state, step, metrics)

    def restore(self, state, which: str = "best"):
        """Load weights, BN statistics, optimizer state and step of
        ``root/<which>`` into ``state`` (in place, onto its device);
        returns ``(state, meta)``."""
        if self.backend == "dcp":
            return load_checkpoint_dcp(os.path.join(self.root, which), state)
        blob = _read(self.root, which)
        unwrap(state.model).load_state_dict(blob["state_dict"])
        if "optimizer" in blob:
            with keeping_own_flags(state.optimizer):
                state.optimizer.load_state_dict(blob["optimizer"])
        state.step = int(blob.get("step", blob["meta"].get("step", 0)))
        return state, blob["meta"]

    def best_metrics(self) -> Dict[str, float]:
        if self.backend == "dcp":
            meta_path = os.path.join(self.root, "best", "scv_meta.json")
            if not os.path.exists(meta_path):
                return {}
            with open(meta_path) as f:
                return json.load(f).get("metrics", {})
        if not os.path.exists(_file(self.root, "best")):
            return {}
        return _read(self.root, "best")["meta"].get("metrics", {})

"""The port's checkpoint format and the best/latest checkpoint manager.

A checkpoint is one file ``<dir>/<which>/model.pt`` (``which`` is
``best`` or ``latest``, as the JAX package's ``<dir>/best``): one
``torch.save`` of ``{"arch", "model_kwargs", "state_dict", "meta"}`` plus,
when a training state is saved, ``"optimizer"`` (the optimizer's
``state_dict``) and ``"step"``. ``arch`` names the model class
(``"unet"``, ``"siamese"`` or ``"deeplab"``, :data:`ARCHS`); a file without
it (written before the Siamese model was ported) holds a ``UNet``. ``model_kwargs``
are the constructor arguments (the model's ``kwargs``); ``meta`` is a
JSON-able dict ``{"step", "metrics"}``. ``predict.load_model`` reads
``<dir>/best``.

The JAX package's msgpack checkpoints (``<dir>/state.msgpack`` from
``flax.serialization.to_bytes`` plus ``meta.json``) are read by
:func:`read_flax_checkpoint` through the port's own decoder
(``train/flax_msgpack.py``; no ``msgpack``, ``flax`` or ``jax`` import),
and :func:`load_flax_weights` puts their ``params``/``batch_stats`` into a
model of the port with ``models.bridge.flax_to_torch``; ``opt_state`` is decoded
but not used. Orbax checkpoints are not ported.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple, Union

import torch

from satellite_computervision_tpu_torch.models.bridge import flax_to_torch
from satellite_computervision_tpu_torch.models.deeplab import DeepLabV3Plus
from satellite_computervision_tpu_torch.models.siamese import SiameseUNet
from satellite_computervision_tpu_torch.models.unet import UNet
from satellite_computervision_tpu_torch.train import flax_msgpack

Model = Union[UNet, SiameseUNet, DeepLabV3Plus]
ARCHS = {"unet": UNet, "siamese": SiameseUNet, "deeplab": DeepLabV3Plus}


def build_empty(build, *args, **kwargs) -> Model:
    """``build(*args, **kwargs)`` on the meta device: no initial weights are
    drawn (seconds on the CPU for a ResNet-50 DeepLab); the weights come
    next from ``load_state_dict(..., assign=True)``."""
    with torch.device("meta"):
        return build(*args, **kwargs)


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


class CheckpointManager:
    """Keeps the ``best`` and ``latest`` training checkpoints under
    ``root``."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def save(self, state, step: int, metrics: Optional[Dict[str, float]] = None):
        meta = {"step": int(step), "metrics": metrics or {}}
        for which in ("best", "latest"):
            save_checkpoint(self.root, state.model, meta, which=which,
                            optimizer=state.optimizer, step=step)

    def restore(self, state, which: str = "best"):
        """Load weights, BN statistics, optimizer state and step of
        ``root/<which>`` into ``state`` (in place, onto its device);
        returns ``(state, meta)``."""
        blob = _read(self.root, which)
        state.model.load_state_dict(blob["state_dict"])
        if "optimizer" in blob:
            state.optimizer.load_state_dict(blob["optimizer"])
        state.step = int(blob.get("step", blob["meta"].get("step", 0)))
        return state, blob["meta"]

    def best_metrics(self) -> Dict[str, float]:
        if not os.path.exists(_file(self.root, "best")):
            return {}
        return _read(self.root, "best")["meta"].get("metrics", {})

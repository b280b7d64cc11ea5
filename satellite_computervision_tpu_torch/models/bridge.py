"""Weight bridge: flax model variables (nested dicts of numpy arrays) ->
the port's ``state_dict``, for the ``UNet``, the ``SiameseUNet`` and
``DeepLabV3Plus``.

The port's module names follow the flax tree, so a torch key
``DecoderBlock_0.Conv_1.weight`` reads from
``params["DecoderBlock_0"]["Conv_1"]["kernel"]``. A tree of another
architecture (a U-Net tree for a Siamese model, or the reverse) has
leaves without a place and keys without a source, and raises. What
changes on the way:

- conv kernels go from HWIO to OIHW; a conv without a bias (DeepLab's
  backbone and decoder, ``use_bias=False``) reads none;
- transposed-conv kernels are flipped in space and go from HWIO to
  (in, out, kh, kw): flax's ``ConvTranspose`` (no kernel transpose)
  convolves the dilated input with the kernel as is, torch's
  ``ConvTranspose2d`` with the spatially flipped kernel;
- BatchNorm ``scale``/``bias`` become ``weight``/``bias`` and
  ``batch_stats`` ``mean``/``var`` the running buffers.

Works for unfolded trees (``{params, batch_stats}``) and folded ones
(``params`` only, with ``affine_0_scale/bias``); the target ``model``
decides which keys are expected. Every leaf of the flax tree must be used.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn


def _get(tree: Mapping, path, used: set, root: str) -> np.ndarray:
    node = tree
    for p in path:
        if not isinstance(node, Mapping) or p not in node:
            raise KeyError(f"flax {root} has no entry {'/'.join(path)}")
        node = node[p]
    used.add((root,) + tuple(path))
    return np.array(node, np.float32)  # a writable copy for torch.from_numpy


def _leaves(tree: Mapping, root: str, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, root, prefix + (k,))
        else:
            yield (root,) + prefix + (k,)


def flax_to_torch(params: Mapping, batch_stats: Optional[Mapping],
                  model: nn.Module) -> Dict[str, torch.Tensor]:
    """Map flax ``params``/``batch_stats`` onto ``model.state_dict()``'s
    keys. Raises if a key has no flax source or a flax leaf is unused."""
    batch_stats = batch_stats or {}
    used: set = set()
    out: Dict[str, torch.Tensor] = {}

    def P(path):
        return _get(params, path, used, "params")

    def S(path):
        return _get(batch_stats, path, used, "batch_stats")

    for name, mod in model.named_modules():
        path = tuple(name.split(".")) if name else ()
        pre = f"{name}." if name else ""
        if isinstance(mod, nn.ConvTranspose2d):
            k = P(path + ("kernel",))
            out[pre + "weight"] = torch.from_numpy(
                np.ascontiguousarray(k[::-1, ::-1].transpose(2, 3, 0, 1)))
            out[pre + "bias"] = torch.from_numpy(P(path + ("bias",)))
        elif isinstance(mod, nn.Conv2d):
            k = P(path + ("kernel",))
            out[pre + "weight"] = torch.from_numpy(
                np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
            if mod.bias is not None:  # DeepLab's backbone convs have none
                out[pre + "bias"] = torch.from_numpy(P(path + ("bias",)))
        elif isinstance(mod, nn.BatchNorm2d):
            out[pre + "weight"] = torch.from_numpy(P(path + ("scale",)))
            out[pre + "bias"] = torch.from_numpy(P(path + ("bias",)))
            out[pre + "running_mean"] = torch.from_numpy(S(path + ("mean",)))
            out[pre + "running_var"] = torch.from_numpy(S(path + ("var",)))
            out[pre + "num_batches_tracked"] = torch.tensor(0)
        else:
            for pname, _ in mod.named_parameters(recurse=False):
                out[pre + pname] = torch.from_numpy(P(path + (pname,)))

    unused = (set(_leaves(params, "params")) | set(_leaves(batch_stats, "batch_stats"))) - used
    if unused:
        raise KeyError(f"flax leaves with no place in the model: {sorted(unused)}")
    missing = set(model.state_dict()) - set(out)
    if missing:
        raise KeyError(f"model keys with no flax source: {sorted(missing)}")
    return out

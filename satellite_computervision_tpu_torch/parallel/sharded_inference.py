"""Mesh-sharded full-scene inference.

Port of ``satellite_computervision_tpu/parallel/sharded_inference.py``:
weights on every rank once; each chip batch of the engine is split along
the mesh's data axis, each rank forwards its contiguous share, and the
predictions are all-gathered, so every rank then blends the whole batch
(through ``kernels/stitch.py::hann_stitch`` with ``blend="hann"``) as the
single-device engine does. One engine forward thus covers ``n_ranks`` x
the chips a rank forwards. Every rank calls ``predict_scene`` on the same
scene.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from satellite_computervision_tpu_torch.inference.tiles import TiledInferenceEngine
from satellite_computervision_tpu_torch.parallel.mesh import axis_size


def make_sharded_predict_fn(predict_fn: Callable, mesh, data_axis: str = "data") -> Callable:
    """Wrap a chip-batch ``predict_fn`` so each rank forwards its share of
    the batch along ``data_axis`` and returns the all-gathered batch."""
    group, size = mesh.get_group(data_axis), axis_size(mesh, data_axis)
    index = mesh.get_local_rank(data_axis)

    def sharded(chips: torch.Tensor) -> torch.Tensor:
        n = chips.shape[0]
        if n % size:
            raise ValueError(f"a chip batch of {n} does not split over {size} ranks")
        b = n // size
        local = predict_fn(chips[index * b : (index + 1) * b]).contiguous()
        parts = [torch.empty_like(local) for _ in range(size)]
        dist.all_gather(parts, local, group=group)
        return torch.cat(parts)

    return sharded


class ShardedTiledInference(TiledInferenceEngine):
    """:class:`TiledInferenceEngine` whose per-batch forward runs data
    parallel across ``mesh``'s ``data_axis``. ``batch_size`` must be a
    multiple of the axis size. Engine keyword arguments pass through
    (``device`` defaults to ``"cuda"``, as the engine's)."""

    def __init__(self, predict_fn: Callable, mesh, data_axis: str = "data", **kwargs):
        if kwargs.get("batch_size", 16) % axis_size(mesh, data_axis):
            raise ValueError(
                "batch_size must be divisible by the data-axis size "
                f"({axis_size(mesh, data_axis)})"
            )
        super().__init__(make_sharded_predict_fn(predict_fn, mesh, data_axis), **kwargs)
        self.mesh = mesh

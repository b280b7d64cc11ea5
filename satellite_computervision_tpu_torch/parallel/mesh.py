"""Process-group meshes and rank-local batches.

Port of ``satellite_computervision_tpu/parallel/mesh.py``. A JAX mesh names
axes over devices that one program drives; here every device is driven by
a rank of a ``torch.distributed`` process group, one device per rank, and
a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks,
with the same named axes. Where JAX places a global batch on the mesh,
each rank here holds its contiguous slice of the batch along the data
axis, in the order the JAX data axis lays the shards out (rank ``i`` of
``n`` holds rows ``[i*B/n, (i+1)*B/n)``).

:func:`initialize_distributed` starts the group: NCCL for a CUDA device,
gloo for the CPU; the backend follows the device asked for, it is never a
fallback.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from satellite_computervision_tpu_torch._device import resolve_device


def initialize_distributed(coordinator: Optional[str] = None, device="cuda",
                           num_processes: int = 1, process_id: int = 0,
                           timeout: Optional[float] = None) -> None:
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id`` (the JAX ``jax.distributed.initialize`` names).
    ``coordinator``: ``host:port`` (TCP) or an init URL (``tcp://...``,
    ``file://...``). ``device`` ``"cuda"`` (default; raises without CUDA)
    takes NCCL and makes ``cuda:<process_id mod device count>`` this rank's
    device, ``"cpu"`` takes gloo. ``timeout`` in seconds bounds every
    collective. A no-op without a coordinator or when a group is already
    up."""
    dev = resolve_device(device)
    if coordinator is None or dist.is_initialized():
        return
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else process_id % torch.cuda.device_count())
    kwargs = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=init,
                            world_size=num_processes, rank=process_id, **kwargs)


def make_mesh(axis_shapes: Optional[Sequence[Tuple[str, int]]] = None,
              devices: Optional[Sequence[int]] = None) -> DeviceMesh:
    """A ``DeviceMesh`` over ``devices`` (ranks; default every rank of the
    group), 1-D ``data`` by default. ``axis_shapes`` like ``[("data", 4),
    ("model", 2)]``; a size of -1 takes what is left (as in reshape). A
    shape that does not cover the ranks raises. The mesh's device type is
    ``cuda`` under NCCL, ``cpu`` under gloo."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_distributed")
    ranks = list(range(dist.get_world_size())) if devices is None else [int(r) for r in devices]
    if axis_shapes is None:
        axis_shapes = [("data", len(ranks))]
    names = tuple(name for name, _ in axis_shapes)
    sizes = [size for _, size in axis_shapes]
    known = int(np.prod([s for s in sizes if s != -1]))
    sizes = [len(ranks) // known if s == -1 else s for s in sizes]
    if int(np.prod(sizes)) != len(ranks):
        raise ValueError(f"mesh {sizes} does not cover {len(ranks)} devices")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(sizes), mesh_dim_names=names)


def axis_size(mesh: DeviceMesh, axis: str = "data") -> int:
    """The number of ranks along the named ``axis``."""
    return dist.get_world_size(mesh.get_group(axis))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


@dataclasses.dataclass(frozen=True)
class DataSharding:
    """This rank's part of dim 0: shard ``index`` of ``size`` contiguous,
    equal shards (``size`` 1: the whole, replicated)."""

    index: int
    size: int

    def local(self, x):
        n = x.shape[0]
        if n % self.size:
            raise ValueError(f"a batch of {n} does not split into {self.size} equal shards")
        b = n // self.size
        return x[self.index * b : (self.index + 1) * b]


def data_sharding(mesh: DeviceMesh, axis: str = "data") -> DataSharding:
    """Batch-dim sharding along ``axis``: this rank's coordinate on it."""
    return DataSharding(mesh.get_local_rank(axis), axis_size(mesh, axis))


def replicate(mesh: DeviceMesh) -> DataSharding:
    """Every rank holds the whole batch."""
    return DataSharding(0, 1)


def _tree_map(fn, batch):
    if isinstance(batch, (tuple, list)):
        return type(batch)(_tree_map(fn, b) for b in batch)
    if isinstance(batch, dict):
        return {k: _tree_map(fn, v) for k, v in batch.items()}
    return fn(batch)


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def shard_batch(batch, mesh: DeviceMesh, axis: str = "data"):
    """This rank's slice of a global host batch (an array, or a tuple,
    list or dict of them) along ``axis``, on the rank's device."""
    sharding, dev = data_sharding(mesh, axis), mesh_device(mesh)
    return _tree_map(lambda x: _tensor(sharding.local(x)).to(dev), batch)


def host_local_batch_to_global(batch, mesh: DeviceMesh, axis: str = "data"):
    """The rank's part of the global batch from the slice this process
    loaded (host-side data sharding): that slice itself, on the rank's
    device. In a group of one rank the batch is global and is sharded as
    :func:`shard_batch` does."""
    if dist.get_world_size() == 1:
        return shard_batch(batch, mesh, axis)
    dev = mesh_device(mesh)
    return _tree_map(lambda x: _tensor(x).to(dev), batch)

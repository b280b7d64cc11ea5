"""Parallel training and serving over a ``torch.distributed`` mesh.

Port of ``satellite_computervision_tpu/parallel``: data-parallel training
with global-batch BatchNorm (``data_parallel``), chip batches sharded over
the ranks (``sharded_inference``), scenes split into row bands with a halo
exchange (``spatial``), and the meshes and rank-local batches they run on
(``mesh``). One device per rank; ``mesh.initialize_distributed`` starts
the group (NCCL on CUDA, gloo on the CPU).
"""

from satellite_computervision_tpu_torch.parallel.data_parallel import (
    GlobalBatchNorm,
    make_parallel_eval_step,
    make_parallel_train_step,
    shard_train_state,
    use_global_batchnorm,
)
from satellite_computervision_tpu_torch.parallel.mesh import (
    axis_size,
    data_sharding,
    host_local_batch_to_global,
    initialize_distributed,
    make_mesh,
    replicate,
    shard_batch,
)
from satellite_computervision_tpu_torch.parallel.sharded_inference import (
    ShardedTiledInference,
    make_sharded_predict_fn,
)
from satellite_computervision_tpu_torch.parallel.spatial import make_spatial_inference

__all__ = [
    "make_mesh",
    "axis_size",
    "data_sharding",
    "replicate",
    "shard_batch",
    "host_local_batch_to_global",
    "initialize_distributed",
    "make_parallel_train_step",
    "make_parallel_eval_step",
    "shard_train_state",
    "GlobalBatchNorm",
    "use_global_batchnorm",
    "make_sharded_predict_fn",
    "ShardedTiledInference",
    "make_spatial_inference",
]

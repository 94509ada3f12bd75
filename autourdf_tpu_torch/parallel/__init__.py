"""Multi-rank scaling over ``torch.distributed`` (port of autourdf_tpu.parallel);
``parallel.launch`` starts the ranks."""

from .sharding import (
    active_mesh,
    chamfer_collective,
    make_mesh,
    mesh_scope,
    register_sequences_sharded,
    replicate,
    shard_sequences,
    sharded_chamfer,
    train_step_dp_sp,
)

__all__ = [
    "make_mesh",
    "mesh_scope",
    "active_mesh",
    "shard_sequences",
    "replicate",
    "register_sequences_sharded",
    "sharded_chamfer",
    "chamfer_collective",
    "train_step_dp_sp",
]

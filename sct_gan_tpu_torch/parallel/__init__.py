"""Meshes of ranks for the port: ``sct_gan_tpu/parallel`` on torch.distributed.

``mesh`` — ("dp", "mp") meshes, batch placement, the mp partition rules;
``sequence`` — ("dp", "sp") meshes and the sequence-parallel encode;
``collectives`` — the collectives and their gradients.
"""
from .mesh import (
    make_mesh,
    batch_sharding,
    replicated_sharding,
    shard_batch,
    shard_params,
    param_partition_spec,
    prefetch_to_device,
)
from .sequence import make_sp_mesh, sp_detect, sp_encode

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "shard_params",
    "param_partition_spec",
    "make_sp_mesh",
    "sp_encode",
    "sp_detect",
]

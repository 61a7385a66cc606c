"""Tensor-, data- and pipeline-parallel engines over `torch.distributed`:
meshes of ranks and the sharded layout (`sharding`), the pipeline stages
(`pipeline`) and the launcher of N ranks (`launch`)."""

from .sharding import (
    Mesh,
    make_mesh,
    make_multihost_mesh,
    mesh_from_args,
    param_pspecs,
    cache_pspecs,
    serving_cache_pspecs,
    shard_params,
    shard_cache,
    shard_serving_cache,
    validate_tp,
    load_param_tree_sharded,
)

__all__ = [
    "Mesh", "make_mesh", "make_multihost_mesh", "mesh_from_args",
    "param_pspecs", "cache_pspecs", "serving_cache_pspecs", "shard_params",
    "shard_cache", "shard_serving_cache", "validate_tp",
    "load_param_tree_sharded",
]

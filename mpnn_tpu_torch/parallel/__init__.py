"""Parallelism over processes (counterpart of `mpnn_tpu/parallel`):
meshes of ranks (`mesh`) and multi-process runs (`multihost`)."""

from .mesh import (make_mesh, replicate_tree, make_sweep_mesh,
                   shard_params, shard_sweep_tree, unshard_params)
from . import multihost

__all__ = ["make_mesh", "replicate_tree", "make_sweep_mesh", "shard_params",
           "shard_sweep_tree", "unshard_params", "multihost"]

"""Data parallelism over processes (`mesh.py`) with BatchNorm over the
global batch (`sync_bn.py`)."""

from .mesh import (Mesh, all_reduce_grads, barrier, broadcast_one_to_all,
                   gather_to_primary, init_distributed, make_mesh,
                   per_host_data_slicing_ok, replicate_state, shard_batch)

__all__ = ["Mesh", "all_reduce_grads", "barrier",
           "broadcast_one_to_all", "gather_to_primary", "init_distributed",
           "make_mesh", "per_host_data_slicing_ok", "replicate_state",
           "shard_batch"]

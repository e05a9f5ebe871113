"""Parallelism over processes: the data, spatial and model axes of a mesh
(`mesh.py`), BatchNorm over the global batch (`sync_bn.py`), DLASeg on
slabs of image rows (`spatial.py`) and the wide layers' output channels
sharded (`model_axis.py`)."""

from .mesh import (Mesh, all_reduce_grads, barrier, broadcast_one_to_all,
                   gather_to_primary, init_distributed, make_mesh,
                   per_host_data_slicing_ok, replicate_state, shard_batch)

__all__ = ["Mesh", "all_reduce_grads", "barrier",
           "broadcast_one_to_all", "gather_to_primary", "init_distributed",
           "make_mesh", "per_host_data_slicing_ok", "replicate_state",
           "shard_batch"]

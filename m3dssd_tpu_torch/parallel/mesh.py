"""Data parallelism over processes: the data axis of the reference
package's `parallel/mesh.py`.

One process runs per card, started by torchrun (`python -m
torch.distributed.run --nproc_per_node k ...`). Every rank holds the whole
model; rank r takes rows [r B/W, (r+1) B/W) of each global batch of B rows
(the loader decodes only those, `data/loader.py`). A step over W ranks
computes the single-process step on the global batch, as the reference's
GSPMD step over a 'data' mesh does:

  * BatchNorm normalises by the statistics of the global batch
    (`parallel/sync_bn.py`, used by the models `build(group=...)` makes);
  * the loss's batch-wide counts and the denominators of its means are
    global (`losses/rpn_loss.py`), so each rank's loss is its share of the
    global loss;
  * the gradients are summed over the ranks (`all_reduce_grads`), which
    gives the gradient of the global loss.

Only the data axis is ported. The reference's 'spatial' and 'model' axes
(image height and wide output channels sharded across devices) raise
`NotImplementedError`; they stay queued in ROADMAP.md (queue 1, item 3).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

# gradients and state travel in flat buckets of about this size, one
# collective each (DistributedDataParallel's default bucket size)
BUCKET_BYTES = 25 * 2 ** 20
UNPORTED_AXES = ("the spatial and model mesh axes are not ported "
                 "(ROADMAP.md, queue 1, item 3: the spatial and model axes)")


@dataclasses.dataclass
class Mesh:
    """The data axis as this process sees it: its `rank` among the `size`
    ranks of `group`, and the device it computes on. A process whose global
    rank is not below `size` is outside the axis (`member` is False) and
    takes part in none of its collectives. `group` is None for one process
    without torch.distributed; collectives then do nothing."""
    rank: int
    size: int
    group: Optional[Any]
    device: torch.device

    @property
    def member(self) -> bool:
        return self.rank < self.size

    @property
    def primary(self) -> bool:
        return self.rank == 0


def world() -> tuple:
    """(rank, world size) of the default process group; (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(backend: Optional[str] = None, device=None,
                     init_method: str = "env://") -> int:
    """Join the process group torchrun describes in the environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); a no-op when a group
    exists. Returns the world size.

    The backend is NCCL for a card (the rank's device is cuda:LOCAL_RANK,
    made current here) and gloo for `device="cpu"`. A caller may pass
    backend="gloo" with CUDA tensors: NCCL refuses two ranks on one card,
    gloo holds them, moving CUDA tensors through the host for all_reduce,
    broadcast and barrier (the only collectives the port runs on them).
    `init_method` may name a `file://` store instead of the environment's
    address.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise RuntimeError("RANK and WORLD_SIZE are not set: launch with "
                           "torchrun (python -m torch.distributed.run "
                           "--nproc_per_node k ...)")
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return dist.get_world_size()


def make_mesh(n_devices: int = -1, spatial: int = 1, model: int = 1,
              device=None) -> Mesh:
    """The data axis over the first `n_devices` ranks (-1, 0 or None: every
    rank). Every rank of the default group calls it (a sub-axis makes a new
    group). `device` defaults to the rank's card (`resolve_device`); under
    torchrun with NCCL that is cuda:LOCAL_RANK.

    On a card, local rank 0 builds the CUDA kernels while the other ranks
    of its host wait at a barrier, so a fresh tree runs nvcc once per host.
    """
    if max(spatial, 1) > 1 or max(model, 1) > 1:
        raise NotImplementedError(UNPORTED_AXES)
    rank, size = world()
    n = size if n_devices in (-1, 0, None) else int(n_devices)
    if not 1 <= n <= size:
        raise ValueError(f"a data axis of {n} ranks in a world of {size}")
    dev = resolve_device(device)
    if size == 1 and not dist.is_initialized():
        group = None
    elif n == size:
        group = dist.group.WORLD
    else:
        group = dist.new_group(list(range(n)))
    mesh = Mesh(rank=rank, size=n, group=group, device=dev)
    if dev.type == "cuda" and mesh.member:
        build_kernels(mesh)
    return mesh


def build_kernels(mesh: Mesh) -> None:
    """Build the CUDA kernels (`ops/_build.py`) on local rank 0 while the
    other ranks wait at a barrier, then let them find the libraries."""
    from ..ops import _build

    local = int(os.environ.get("LOCAL_RANK", mesh.rank))
    if local == 0:
        _build.build()
    barrier(mesh)
    if local != 0:
        _build.build()


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None and mesh.group is not None:
        dist.barrier(group=mesh.group)


def _object_device(mesh: Mesh) -> torch.device:
    """Where object collectives stage their bytes: NCCL moves only CUDA
    tensors, gloo takes host tensors."""
    if dist.get_backend(mesh.group) == "nccl":
        return mesh.device
    return torch.device("cpu")


def broadcast_one_to_all(value, mesh: Optional[Mesh]):
    """Rank 0's `value` (any picklable object) on every rank: the twin of
    JAX's `multihost_utils.broadcast_one_to_all`."""
    if mesh is None or mesh.group is None:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0, group=mesh.group,
                               device=_object_device(mesh))
    return box[0]


def gather_to_primary(value, mesh: Optional[Mesh]) -> Optional[List]:
    """Every rank's `value` (picklable, on the host), in rank order, on rank
    0; None on the other ranks."""
    if mesh is None or mesh.group is None:
        return [value]
    out = [None] * mesh.size if mesh.primary else None
    dist.gather_object(value, out, dst=0, group=mesh.group)
    return out


def per_host_data_slicing_ok(mesh: Optional[Mesh]) -> bool:
    """True when each process can decode only its own rows of the global
    batch: a data axis of several ranks, one process per rank, in rank
    order (how `make_mesh` lays it out)."""
    return mesh is not None and mesh.size > 1 and mesh.member


def shard_batch(mesh: Mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's rows of a global host batch: rows [r B/W, (r+1) B/W) of
    every array's leading dim."""
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        if B % mesh.size:
            raise ValueError(f"{k}: {B} rows over {mesh.size} ranks")
        b = B // mesh.size
        out[k] = v[mesh.rank * b:(mesh.rank + 1) * b]
    return out


def _bucketed(tensors: Sequence[torch.Tensor],
              op: Callable[[torch.Tensor], None]) -> int:
    """Run the in-place collective `op` over `tensors` in flat buckets of
    about BUCKET_BYTES (one dtype and device per bucket, in the order
    given, which every rank must share) and copy the results back. Returns
    the bytes moved."""
    pending: Dict[tuple, List[torch.Tensor]] = {}
    sizes: Dict[tuple, int] = {}
    total = 0

    def flush(key):
        bucket = pending.pop(key)
        sizes.pop(key)
        flat = torch.cat([t.reshape(-1) for t in bucket])
        op(flat)
        for t, v in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(v.view(t.shape))

    for t in tensors:
        key = (t.dtype, t.device)
        pending.setdefault(key, []).append(t)
        nbytes = t.numel() * t.element_size()
        sizes[key] = sizes.get(key, 0) + nbytes
        total += nbytes
        if sizes[key] >= BUCKET_BYTES:
            flush(key)
    for key in list(pending):
        flush(key)
    return total


def all_reduce_grads(grads: Sequence[torch.Tensor], group) -> int:
    """Sum `grads` in place over the ranks of `group`: buckets of about
    BUCKET_BYTES, one all_reduce(SUM) each. Returns the bytes reduced (0
    without a group)."""
    if group is None:
        return 0
    return _bucketed(grads, lambda flat: dist.all_reduce(flat, group=group))


def replicate_state(mesh: Mesh, state) -> None:
    """Rank 0's train state on every rank, in place: the model's parameters
    and buffers, the optimizer's buffers and counts and the step."""
    if mesh.group is None:
        return
    opt = state.optimizer
    tensors = list(state.model.state_dict().values())
    tensors += [t for n in sorted(opt.state)
                for _, t in sorted(opt.state[n].items())]
    tensors += [opt.acc[n] for n in sorted(opt.acc)]
    _bucketed(tensors, lambda flat: dist.broadcast(flat, src=0,
                                                   group=mesh.group))
    state.step, opt.count, opt.mini_step = broadcast_one_to_all(
        (state.step, opt.count, opt.mini_step), mesh)

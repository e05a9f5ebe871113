"""The process mesh of the reference package's `parallel/mesh.py`: the
data, spatial and model axes over processes.

One process runs per card, started by torchrun (`python -m
torch.distributed.run --nproc_per_node k ...`). `make_mesh(n, spatial=sp,
model=mp)` lays the first n ranks out as the reference lays its devices:
(data, spatial, model) with model fastest, so rank r sits at
(r // (sp mp), (r // mp) % sp, r % mp) and the data axis has
dp = n / (sp mp) ranks.

The data axis. Rank d of dp takes rows [d B/dp, (d+1) B/dp) of each global
batch of B rows (the loader decodes only those, `data/loader.py`); every
spatial and model rank of one data coordinate takes the same rows. A step
computes the single-process step on the global batch, as the reference's
GSPMD step over a 'data' mesh does:

  * BatchNorm normalises by the statistics of the global batch
    (`parallel/sync_bn.py`, used by the models `build(mesh=...)` makes);
  * the loss's batch-wide counts and the denominators of its means are
    global (`losses/rpn_loss.py`), so each rank's loss is its share of the
    global loss;
  * the gradients are summed over the ranks (`all_reduce_grads`), which
    gives the gradient of the global loss.

The spatial axis (`parallel/spatial.py`) shards the backbone's image
height: each rank runs DLASeg on its rows with halo exchanges and the
head on the gathered map. The model axis (`parallel/model_axis.py`)
shards the wide layers' output channels, with their BN statistics and
momentum. Backbone gradients are partial per spatial rank and are summed
over data x spatial; the head, computed whole on every spatial rank, is
summed over data only. The model ranks' copies of a replicated parameter
get equal gradients; a sharded parameter's gradient is its own slice.
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
AXES = ("data", "spatial", "model")


@dataclasses.dataclass
class Mesh:
    """The mesh as this process sees it. `rank` and `size` are its data
    coordinate and the data axis's extent, `group` the data axis through
    this rank (the ranks of its spatial and model coordinates); `s` and `m`
    are its spatial and model coordinates among `spatial` and `model`
    ranks. `batch_group` spans the data and spatial axes (BatchNorm and the
    backbone's gradients), `mesh_group` every rank of the mesh. A group that
    spans the whole process group is WORLD (also a world of one rank, where
    the group BN runs alone); otherwise it is None where its axis holds one
    rank. A process whose global rank is not
    below the mesh's rank count is outside the mesh (`member` is False) and
    takes part in none of its collectives."""
    rank: int
    size: int
    group: Optional[Any]
    device: torch.device
    global_rank: int = 0
    spatial: int = 1
    model: int = 1
    s: int = 0
    m: int = 0
    spatial_group: Optional[Any] = None
    model_group: Optional[Any] = None
    batch_group: Optional[Any] = None
    mesh_group: Optional[Any] = None

    @property
    def member(self) -> bool:
        return self.global_rank < self.size * self.spatial * self.model

    @property
    def primary(self) -> bool:
        return self.global_rank == 0

    def __deepcopy__(self, memo):
        return self


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
    gloo holds them, moving CUDA tensors through the host (`all_gather`
    below stages them itself). `init_method` may name a `file://` store
    instead of the environment's address.
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


def mesh_coords(rank: int, spatial: int = 1, model: int = 1) -> tuple:
    """(data, spatial, model) coordinates of mesh rank `rank`: the
    reference's device layout, model fastest."""
    return (rank // (spatial * model), (rank // model) % spatial,
            rank % model)


def axis_groups(n: int, spatial: int = 1, model: int = 1
                ) -> Dict[str, List[List[int]]]:
    """The rank lists of every group of a mesh of n ranks, by axis set:
    "data", "spatial", "model" (the ranks that differ only in that
    coordinate), "batch" (data and spatial: the ranks of one model
    coordinate) and "mesh" (all n)."""
    coords = [mesh_coords(r, spatial, model) for r in range(n)]
    keep = {"data": (1, 2), "spatial": (0, 2), "model": (0, 1),
            "batch": (2,), "mesh": ()}
    out = {}
    for name, fixed in keep.items():
        lists: Dict[tuple, List[int]] = {}
        for r, c in enumerate(coords):
            lists.setdefault(tuple(c[i] for i in fixed), []).append(r)
        out[name] = [lists[k] for k in sorted(lists)]
    return out


def make_mesh(n_devices: int = -1, spatial: int = 1, model: int = 1,
              device=None) -> Mesh:
    """The mesh over the first `n_devices` ranks (-1, 0 or None: every
    rank), `spatial` x `model` of them per data coordinate. Every rank of
    the default group calls it (the axes make new groups). `device`
    defaults to the rank's card (`resolve_device`); under torchrun with
    NCCL that is cuda:LOCAL_RANK.

    On a card, local rank 0 builds the CUDA kernels while the other ranks
    of its host wait at a barrier, so a fresh tree runs nvcc once per host.
    """
    sp, mp = max(int(spatial), 1), max(int(model), 1)
    rank, size = world()
    n = size if n_devices in (-1, 0, None) else int(n_devices)
    if not 1 <= n <= size:
        raise ValueError(f"a mesh of {n} ranks in a world of {size}")
    if n % (sp * mp):
        raise ValueError(f"{n} ranks do not split into spatial {sp} x "
                         f"model {mp}")
    dev = resolve_device(device)
    whole = list(range(size)) if dist.is_initialized() else None
    made: Dict[tuple, Any] = {}
    mine: Dict[str, Any] = {}
    for axis, lists in axis_groups(n, sp, mp).items():
        for ranks in lists:
            # every rank makes every group, in one order; equal rank lists
            # share one group
            key = tuple(ranks)
            if key not in made:
                made[key] = (dist.group.WORLD if ranks == whole else
                             dist.new_group(ranks) if len(ranks) > 1
                             else None)
            if rank in ranks:
                mine[axis] = made[key]
    d, s, m = mesh_coords(rank, sp, mp) if rank < n else (rank, 0, 0)
    mesh = Mesh(rank=d, size=n // (sp * mp), group=mine.get("data"),
                device=dev, global_rank=rank, spatial=sp, model=mp, s=s, m=m,
                spatial_group=mine.get("spatial"),
                model_group=mine.get("model"), batch_group=mine.get("batch"),
                mesh_group=mine.get("mesh"))
    if dev.type == "cuda" and mesh.member:
        build_kernels(mesh)
    return mesh


def build_kernels(mesh: Mesh) -> None:
    """Build the CUDA kernels (`ops/_build.py`) on local rank 0 while the
    other ranks wait at a barrier, then let them find the libraries."""
    from ..ops import _build

    local = int(os.environ.get("LOCAL_RANK", mesh.global_rank))
    if local == 0:
        _build.build()
    barrier(mesh)
    if local != 0:
        _build.build()


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank of the mesh."""
    if mesh is not None and mesh.mesh_group is not None:
        dist.barrier(group=mesh.mesh_group)


def _object_device(mesh: Mesh, group) -> torch.device:
    """Where object collectives stage their bytes: NCCL moves only CUDA
    tensors, gloo takes host tensors."""
    if dist.get_backend(group) == "nccl":
        return mesh.device
    return torch.device("cpu")


def broadcast_one_to_all(value, mesh: Optional[Mesh]):
    """Rank 0's `value` (any picklable object) on every rank of the mesh:
    the twin of JAX's `multihost_utils.broadcast_one_to_all`."""
    if mesh is None or mesh.mesh_group is None:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0, group=mesh.mesh_group,
                               device=_object_device(mesh, mesh.mesh_group))
    return box[0]


def gather_to_primary(value, mesh: Optional[Mesh]) -> Optional[List]:
    """Every data rank's `value` (picklable, on the host), in rank order,
    on data rank 0 of this rank's data axis; None on the other ranks."""
    if mesh is None or mesh.group is None:
        return [value]
    out = [None] * mesh.size if mesh.rank == 0 else None
    dist.gather_object(value, out, dst=dist.get_global_rank(mesh.group, 0),
                       group=mesh.group)
    return out


def per_host_data_slicing_ok(mesh: Optional[Mesh]) -> bool:
    """True when each process can decode only its own rows of the global
    batch: a data axis of several ranks, one process per rank, in rank
    order (how `make_mesh` lays it out)."""
    return mesh is not None and mesh.size > 1 and mesh.member


def shard_batch(mesh: Mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's rows of a global host batch: rows [d B/dp, (d+1) B/dp)
    of every array's leading dim, for data coordinate d (the spatial and
    model ranks of one data coordinate take the same rows)."""
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
    and buffers, the optimizer's buffers and counts and the step. Under a
    model axis each rank keeps its 1/mp slice of every sharded leaf and of
    its momentum (the model holds them so since `build(mesh=...)`), so
    each model coordinate takes the state of its rank on data and spatial
    coordinate 0."""
    if mesh.batch_group is not None:
        opt = state.optimizer
        tensors = list(state.model.state_dict().values())
        tensors += [t for n in sorted(opt.state)
                    for _, t in sorted(opt.state[n].items())]
        tensors += [opt.acc[n] for n in sorted(opt.acc)]
        src = dist.get_global_rank(mesh.batch_group, 0)
        _bucketed(tensors, lambda flat: dist.broadcast(
            flat, src=src, group=mesh.batch_group))
    state.step, state.optimizer.count, state.optimizer.mini_step = \
        broadcast_one_to_all((state.step, state.optimizer.count,
                              state.optimizer.mini_step), mesh)


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's `t` (one shape on every rank) in group rank order.
    gloo moves a CUDA tensor through the host: it is staged there and
    back here."""
    n = dist.get_world_size(group)
    stage = t.is_cuda and dist.get_backend(group) == "gloo"
    src = (t.detach().to("cpu") if stage else t.detach()).contiguous()
    if src.dtype == torch.bfloat16:     # a copy: moved as 16-bit words
        src = src.view(torch.float16)
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=group)
    return [o.view(t.dtype).to(t.device) for o in out]

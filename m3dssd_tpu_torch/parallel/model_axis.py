"""The model axis: the wide layers' output channels sharded over ranks.

The reference shards every parameter leaf whose trailing dim is at least
`min_model_dim` (128) and divides by the axis's extent mp, over its
'model' mesh axis (`m3dssd_tpu/parallel/mesh.py:replicate_state`): conv
kernels [kh, kw, cin, cout] by cout, their bias, BN scale, bias and
statistics by channel, the DCN and align weights [K, K, Cin, Cout] by
Cout; optimizer momentum follows its parameter. GSPMD then moves the
activations. Here the same leaves are sharded (`shard_specs`, through the
names of `utils/weights.py`), and each layer that holds them runs
column-parallel, Megatron's form:

  * the input passes `copy_to` (identity forward, all_reduce of the
    gradient over the model group backward), since every rank's slice of
    the output reads all of it;
  * the layer runs on its own output channels (a conv, a DCN at Cout/mp,
    an align module; a grouped or depthwise conv and a BN on the matching
    input channels), BN with its statistics over the data x spatial group;
  * `gather` all-gathers the output along channels; its backward keeps
    the rank's slice of the (replicated) gradient.

A conv, BN and activation in a row (`ConvBNAct`, `DeformConv`, the
towers) gather once, after the activation. The DCN's offset and mask conv
(27 channels) stays replicated; its outputs pass `copy_to` too, because
each rank's kernel call differentiates them by its own channels only.

`LocalConv2d`'s banded kernel [r*F, C, k, k] keeps F/mp channels of every
band (an interleaved 1/mp slice, `blocks` = r), so a rank holds its
channels of the bands its rows cover under the spatial axis as well.

State. `shard_model` slices the parameters and BN statistics in place
after the model is built; `load_state_dict` then takes whole tensors and
keeps the rank's slice (a load pre-hook per sharded module), so a
checkpoint of any mp restores at any other. `full_state_dict` and
`full_optimizer_state` (collectives over the model group) give the whole
tensors a checkpoint holds.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from .mesh import all_gather

MIN_MODEL_DIM = 128


class ModelShard:
    """Rank `index` of the `size` ranks of the model `group`."""

    def __init__(self, index: int, size: int, group):
        self.index, self.size, self.group = index, size, group

    def __deepcopy__(self, memo):
        return self

    def part(self, n: int) -> slice:
        """This rank's part of n channels."""
        k = n // self.size
        return slice(self.index * k, (self.index + 1) * k)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.shard.group)
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, shard):
        ctx.shard, ctx.n = shard, y.shape[1]
        return torch.cat(all_gather(y, shard.group), dim=1)

    @staticmethod
    def backward(ctx, g):
        i, n = ctx.shard.index, ctx.n
        return g[:, i * n:(i + 1) * n], None


def copy_to(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """Identity forward; the gradient summed over the model group."""
    return _CopyTo.apply(x, shard)


def enter(x: torch.Tensor, shard: ModelShard,
          channels: bool = False) -> torch.Tensor:
    """A column-parallel layer's input: `copy_to`, and with `channels` only
    this rank's channels (dim 1; a BN, a depthwise or grouped conv)."""
    x = copy_to(x, shard)
    return x[:, shard.part(x.shape[1])] if channels else x


def gather(y: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """The ranks' channel slices [B, n, ...] -> [B, size n, ...]."""
    out = _Gather.apply(y, shard)
    if y.dim() == 4 and y.is_contiguous(memory_format=torch.channels_last):
        out = out.contiguous(memory_format=torch.channels_last)
    return out


def channel_dim(module: nn.Module, name: str, t: torch.Tensor) -> int:
    """The dim of `t` that is the reference leaf's trailing dim: a conv or
    transposed-conv kernel's output channels (HWIO -> OIHW,
    utils/weights.py), the last dim of every other leaf."""
    if name == "weight" and isinstance(module, (nn.Conv2d,
                                                nn.ConvTranspose2d)):
        return 0
    return t.dim() - 1


def _leaves(module: nn.Module):
    """(name, tensor) of a module's own leaves of the reference tree:
    its parameters and BN's running statistics."""
    for n, p in module.named_parameters(recurse=False):
        yield n, p
    if isinstance(module, nn.BatchNorm2d):
        yield "running_mean", module.running_mean
        yield "running_var", module.running_var


def _blocks(module: nn.Module) -> int:
    """LocalConv2d's banded conv shards F/mp channels of each band."""
    return module._bands if isinstance(module, nn.Conv2d) and getattr(
        module, "_bands", None) else 1


def _shardable(module: nn.Module, n: int, size: int, blocks: int) -> bool:
    if (n // blocks) % size:
        return False
    groups = getattr(module, "groups", 1)
    if blocks > 1:
        return True
    return groups == 1 or groups % size == 0


def shard_specs(model: nn.Module, size: int,
                min_dim: int = MIN_MODEL_DIM) -> Dict[str, tuple]:
    """{state-dict name: (module, leaf name, dim, blocks)} of every leaf
    the reference's rule shards over a model axis of `size`: trailing dim
    >= min_dim and divisible by size (whole modules: a conv's kernel and
    bias share their channels)."""
    from ..models.align import CenterAlign, ShapeAlign
    from ..models.layers import BatchNorm2d, BilinearUpsample, Conv2d
    from ..models.necks import DCN, DeformLocConv

    known = (Conv2d, BilinearUpsample, BatchNorm2d, DCN, ShapeAlign,
             CenterAlign, DeformLocConv)
    out = {}
    for mname, mod in model.named_modules():
        leaves = list(_leaves(mod))
        wide = [(n, t, channel_dim(mod, n, t)) for n, t in leaves
                if t.dim() >= 1]
        wide = [(n, t, d) for n, t, d in wide
                if t.shape[d] >= min_dim and t.shape[d] % size == 0]
        if not wide or size == 1:
            continue
        if not isinstance(mod, known):
            raise NotImplementedError(
                f"{mname} ({type(mod).__name__}) holds leaves the model "
                "axis shards, and has no column-parallel form")
        blocks = _blocks(mod)
        if not all(_shardable(mod, t.shape[d], size, blocks)
                   for _, t, d in wide):
            continue
        for n, t, d in wide:
            out[f"{mname}.{n}" if mname else n] = (mod, n, d, blocks)
    return out


def _slice(t: torch.Tensor, dim: int, blocks: int, index: int,
           size: int) -> torch.Tensor:
    """Rank `index`'s 1/size of `t` along `dim`: within each of `blocks`
    equal blocks, its contiguous part."""
    n = t.shape[dim]
    v = t.unflatten(dim, (blocks, n // blocks))
    k = n // blocks // size
    return v.narrow(dim + 1, index * k, k).flatten(dim, dim + 1).clone()


def _unslice(parts, dim: int, blocks: int) -> torch.Tensor:
    """The inverse of `_slice` over every rank's part, in rank order."""
    views = [p.unflatten(dim, (blocks, p.shape[dim] // blocks))
             for p in parts]
    return torch.cat(views, dim=dim + 1).flatten(dim, dim + 1)


def shard_model(model: nn.Module, shard: ModelShard) -> Dict[str, tuple]:
    """Keep this rank's slice of every leaf of `shard_specs` (at
    MIN_MODEL_DIM), in place, and set `model_shard` on the modules that
    hold them. Returns the specs (kept as `model._model_specs`)."""
    specs = shard_specs(model, shard.size, MIN_MODEL_DIM)
    full = {}
    with torch.no_grad():
        for name, (mod, leaf, dim, blocks) in specs.items():
            t = getattr(mod, leaf)
            full[name] = tuple(t.shape)
            t.data = _slice(t.data, dim, blocks, shard.index, shard.size)
            if not hasattr(mod, "_full_shapes"):
                mod._full_shapes = {}
                mod._register_load_state_dict_pre_hook(_load_hook,
                                                       with_module=True)
            mod._full_shapes[leaf] = (tuple(full[name]), dim, blocks)
            mod.model_shard = shard
    model._model_specs = specs
    return specs


def _load_hook(module, state_dict, prefix, *args):
    """Keep this rank's slice of whole tensors loaded into a sharded
    module."""
    shard = module.model_shard
    for leaf, (shape, dim, blocks) in module._full_shapes.items():
        key = prefix + leaf
        t = state_dict.get(key)
        if t is not None and tuple(t.shape) == shape:
            state_dict[key] = _slice(torch.as_tensor(t), dim, blocks,
                                     shard.index, shard.size)


def specs_of(model: nn.Module) -> Dict[str, tuple]:
    return getattr(model, "_model_specs", {})


def slice_like(model: nn.Module, name: str, t: torch.Tensor) -> torch.Tensor:
    """`t`, a whole tensor of state-dict entry `name` (or its optimizer
    buffer), as this rank holds it."""
    spec = specs_of(model).get(name)
    if spec is None:
        return t
    mod, leaf, dim, blocks = spec
    if tuple(t.shape) != mod._full_shapes[leaf][0]:
        return t
    return _slice(t, dim, blocks, mod.model_shard.index,
                  mod.model_shard.size)


def _whole(model: nn.Module, name: str, t: torch.Tensor) -> torch.Tensor:
    mod, leaf, dim, blocks = specs_of(model)[name]
    return _unslice(all_gather(t, mod.model_shard.group), dim, blocks)


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict with whole tensors (a collective over the
    model group: every model rank calls it)."""
    specs = specs_of(model)
    return {k: (_whole(model, k, v) if k in specs else v)
            for k, v in model.state_dict().items()}


def full_optimizer_state(model: nn.Module, optimizer) -> dict:
    """The optimizer's state dict with whole buffers (a collective over the
    model group)."""
    sd = optimizer.state_dict()
    specs = specs_of(model)
    sd["state"] = {n: {k: (_whole(model, n, v) if n in specs else v)
                       for k, v in st.items()}
                   for n, st in sd["state"].items()}
    sd["acc"] = {n: (_whole(model, n, v) if n in specs else v)
                 for n, v in sd["acc"].items()}
    return sd


def shard_group(model: nn.Module) -> Optional[object]:
    """The model group whose ranks hold the slices of the sharded leaves
    (None without any)."""
    for mod, _, _, _ in specs_of(model).values():
        return mod.model_shard.group
    return None

"""The spatial axis: DLASeg on a slab of image rows per rank.

The reference shards image height over its 'spatial' mesh axis and lets
XLA insert the halo exchanges. Here each of the `size` ranks of a spatial
group runs the backbone and the necks on rows [i h, (i+1) h) of every
level (h = the level's height / size) and exchanges the rows a layer reads
beyond its slab:

  * `halo(x, top, bottom, shard)` extends a slab [B, C, h, W] by `top`
    rows above and `bottom` below, fetched from the ranks that hold them
    (zeros past the image's true top and bottom, where a layer pads with
    zeros). Its backward sends the halo's gradient back to those ranks,
    which add it to their own rows. One all_gather each way: every rank
    contributes the rows the others read from it (its first `bottom` and
    last `top` rows, or its whole slab when a halo reaches past a
    neighbour).
  * `gather_rows(x, shard, reduce_grad)` assembles the whole height.
    With `reduce_grad` False (the head, computed whole on every rank, so
    the gradient of the whole map is the same on each) the backward keeps
    the rank's own rows; with True (a layer whose reach is unbounded, the
    unclamped DCN, reads the gathered map at its own rows only) it sums the
    ranks' gradients first.
  * `conv_halo(kernel, stride, padding, dilation)`: the rows a convolution
    reads above and below a slab whose first row is a multiple of the
    stride.

`SpatialShard` is the rank's place on the axis; `build(mesh=...)` sets it
on every layer of DLASeg, and DLASeg switches it on for a forward when
every level's height divides by `size` (else the ranks run the whole
height and say so once, as the reference's detect falls back to data-only
sharding).
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from .mesh import all_gather


class SpatialShard:
    """Rank `index` of the `size` ranks of the spatial `group`; `active`
    while DLASeg runs on slabs."""

    def __init__(self, index: int, size: int, group):
        self.index, self.size, self.group = index, size, group
        self.active = False
        self.warned = False

    def __deepcopy__(self, memo):
        return self

    def check(self, height: int, multiple: int) -> bool:
        """Whether an input of `height` rows shards: every level's height
        (height / multiple at the coarsest) divides by `size`. Logs once
        when it does not."""
        ok = height % (multiple * self.size) == 0
        if not ok and not self.warned:
            logging.warning("spatial axis: input height %d is not a "
                            "multiple of %d x %d; every spatial rank runs "
                            "the whole height", height, multiple, self.size)
            self.warned = True
        return ok


def active(shard: Optional[SpatialShard]) -> Optional[SpatialShard]:
    return shard if shard is not None and shard.active else None


def conv_halo(kernel: int, stride: int, padding: int, dilation: int):
    """(top, bottom) rows a convolution reads past a slab of h rows whose
    first row is a multiple of `stride`, and whose output rows are the
    slab's own (h / stride of them)."""
    top = padding
    bottom = max(0, dilation * (kernel - 1) - padding - (stride - 1))
    return top, bottom


def _rows(pieces, starts, H, a, b, like):
    """Global rows [a, b) from the gathered pieces (piece j holds rows
    starts[j] .. starts[j] + len); zeros outside [0, H)."""
    out = []
    g = a
    while g < b:
        if g < 0 or g >= H:
            e = min(b, 0) if g < 0 else b
            out.append(like.new_zeros(like.shape[:2] + (e - g,)
                                      + like.shape[3:]))
            g = e
            continue
        for t, st in zip(pieces, starts):
            if st <= g < st + t.shape[2]:
                e = min(b, st + t.shape[2], H)
                out.append(t[:, :, g - st:e - st])
                g = e
                break
        else:
            raise AssertionError(f"row {g} held by no piece")
    return torch.cat(out, dim=2) if len(out) > 1 else out[0]


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, top, bottom, shard):
        ctx.top, ctx.bottom, ctx.shard = top, bottom, shard
        h = x.shape[2]
        n, i = shard.size, shard.index
        H = n * h
        first, last = min(bottom, h), min(top, h)
        parts = all_gather(torch.cat([x[:, :, :first], x[:, :, h - last:]],
                                     dim=2), shard.group)
        pieces, starts = [], []
        for j, p in enumerate(parts):
            pieces += [p[:, :, :first], p[:, :, first:]]
            starts += [j * h, (j + 1) * h - last]
        r0 = i * h
        out = [x]
        if top:
            out.insert(0, _rows(pieces, starts, H, r0 - top, r0, x))
        if bottom:
            out.append(_rows(pieces, starts, H, r0 + h, r0 + h + bottom, x))
        return torch.cat(out, dim=2)

    @staticmethod
    def backward(ctx, g):
        top, bottom, shard = ctx.top, ctx.bottom, ctx.shard
        h = g.shape[2] - top - bottom
        parts = all_gather(torch.cat([g[:, :, :top], g[:, :, top + h:]],
                                     dim=2).contiguous(), shard.group)
        dx = g[:, :, top:top + h].clone()
        r0 = shard.index * h
        for j, p in enumerate(parts):
            rj = j * h
            # rank j's halo rows: [rj - top, rj) and [rj + h, rj + h + bottom)
            for start, blk in ((rj - top, p[:, :, :top]),
                               (rj + h, p[:, :, top:])):
                a, b = max(start, r0), min(start + blk.shape[2], r0 + h)
                if a < b:
                    dx[:, :, a - r0:b - r0] += blk[:, :, a - start:b - start]
        return dx, None, None, None


def halo(x: torch.Tensor, top: int, bottom: int,
         shard: SpatialShard) -> torch.Tensor:
    """x [B, C, h, W] (this rank's rows) -> [B, C, top + h + bottom, W]
    with the neighbouring rows above and below (see the module
    docstring)."""
    if top == 0 and bottom == 0:
        return x
    return _Halo.apply(x, int(top), int(bottom), shard)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard, reduce_grad):
        ctx.shard, ctx.reduce_grad, ctx.h = shard, reduce_grad, x.shape[2]
        return torch.cat(all_gather(x, shard.group), dim=2)

    @staticmethod
    def backward(ctx, g):
        shard, h = ctx.shard, ctx.h
        if ctx.reduce_grad:
            g = g.contiguous().clone()
            torch.distributed.all_reduce(g, group=shard.group)
        i = shard.index
        return g[:, :, i * h:(i + 1) * h].contiguous(), None, None


def gather_rows(x: torch.Tensor, shard: SpatialShard,
                reduce_grad: bool = False) -> torch.Tensor:
    """[B, C, h, W] slabs -> [B, C, size h, W] on every rank (see the
    module docstring)."""
    y = _GatherRows.apply(x, shard, bool(reduce_grad))
    if x.is_contiguous(memory_format=torch.channels_last):
        y = y.contiguous(memory_format=torch.channels_last)
    return y


def local_rows(x: torch.Tensor, shard: SpatialShard, dim: int = 2):
    """This rank's rows of a whole-height tensor along `dim`."""
    h = x.shape[dim] // shard.size
    return x.narrow(dim, shard.index * h, h)

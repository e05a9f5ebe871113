"""DLA aggregation necks: DCN, DeformConv, DeformLocConv, IDAUp, DLAUp,
DLASeg.

Upsampling merges the deep levels into the stride-8 map; the projection and
node convs are deformable (DCNv2 with learned offsets) when `use_dcn` is on,
plain 3x3 convs otherwise. With `shift_clamp` set (the flagship: 1.0) every
deformable layer runs `ops.dcn.dcn_v2_shift`, which on the card is the
hand-written kernel: 8 layers for DLASeg(dla102).

Under the spatial axis (`build(mesh=...)`, parallel/spatial.py) DLASeg
runs on its rank's rows of every level and gathers the output map along
height; under the model axis a DCN runs on its own output channels
(parallel/model_axis.py).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.dcn import bilinear_sample, dcn_v2, dcn_v2_shift, shift_geometry
from ..parallel import model_axis
from ..parallel.spatial import active, gather_rows, halo
from .dla import make_dla
from .layers import (BilinearUpsample, Conv2d, batch_norm, conv2d,
                     fold_bands, leaky_relu)


class DCN(nn.Module):
    """Deformable conv with learned offsets and mask.

    A conv (zero-initialised) predicts the channels [dy x KK | dx x KK |
    m x KK]; the mask is their sigmoid. At init the layer is a plain conv
    with offsets 0 and mask 0.5. `weight` keeps the layout [K, K, Cin, Cout]
    that the kernel takes.
    """

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, dilation: int = 1,
                 shift_clamp: Optional[float] = 1.0):
        super().__init__()
        self.kernel, self.stride, self.dilation = kernel, stride, dilation
        self.shift_clamp = shift_clamp
        self.conv_offset_mask = conv2d(cin, 3 * kernel * kernel, kernel,
                                       stride, dilation)
        self.weight = nn.Parameter(torch.empty(kernel, kernel, cin, features))
        self.bias = nn.Parameter(torch.zeros(features))

    @property
    def uses_shift(self) -> bool:
        return (self.shift_clamp is not None and self.stride == 1
                and self.dilation == 1)

    model_shard = None
    spatial_shard = None

    def forward(self, x):
        ms = self.model_shard
        y = self.local(x)
        return model_axis.gather(y, ms) if ms is not None else y

    def local(self, x):
        """This layer's own output channels (all, or its slice under the
        model axis), on this rank's rows under the spatial axis."""
        KK = self.kernel * self.kernel
        om = self.conv_offset_mask(x).permute(0, 2, 3, 1)     # [B,H,W,3KK]
        offset = torch.stack([om[..., :KK], om[..., KK:2 * KK]], dim=-1)
        mask = torch.sigmoid(om[..., 2 * KK:])
        ms = self.model_shard
        if ms is not None:
            # each rank's call differentiates x, offset and mask by its
            # own output channels only
            x, offset, mask = (model_axis.copy_to(t, ms)
                               for t in (x, offset, mask))
        weight = self.weight.to(x.dtype)
        bias = self.bias.to(x.dtype)
        sp = active(self.spatial_shard)
        if sp is not None:
            return self._slab(x, offset, mask, weight, bias, sp)
        xh = x.permute(0, 2, 3, 1).contiguous()               # NHWC
        if self.uses_shift:
            y = dcn_v2_shift(xh, offset, mask, weight, bias,
                             clamp=float(self.shift_clamp))
        else:
            y = dcn_v2(xh, offset, mask, weight, bias, stride=self.stride,
                       padding=self.dilation * (self.kernel - 1) // 2,
                       dilation=self.dilation)
        return y.permute(0, 3, 1, 2)                          # channels_last

    def _slab(self, x, offset, mask, weight, bias, sp):
        """The layer on this rank's rows. The shift form reads K//2 +
        ceil(clamp) rows past the slab: the kernel runs on the slab with
        that halo (offsets and mask zero on the halo rows, whose outputs
        are cut off). The unclamped form reaches any row: it reads the
        gathered map at this rank's output rows."""
        h = offset.shape[1]
        if self.uses_shift:
            pad, R, _ = shift_geometry(float(self.shift_clamp), self.kernel)
            P = pad + R
            xh = halo(x, P, P, sp).permute(0, 2, 3, 1).contiguous()
            offset = F.pad(offset, (0, 0, 0, 0, 0, 0, P, P))
            mask = F.pad(mask, (0, 0, 0, 0, P, P))
            y = dcn_v2_shift(xh, offset, mask, weight, bias,
                             clamp=float(self.shift_clamp))[:, P:P + h]
        else:
            xh = gather_rows(x, sp, reduce_grad=True).permute(
                0, 2, 3, 1).contiguous()
            shift = offset.new_tensor([sp.index * h * self.stride, 0.0])
            y = dcn_v2(xh, offset + shift, mask, weight, bias,
                       stride=self.stride,
                       padding=self.dilation * (self.kernel - 1) // 2,
                       dilation=self.dilation)
        return y.permute(0, 3, 1, 2)


class DeformConv(nn.Module):
    """DCN -> BN -> LeakyReLU."""

    def __init__(self, cin: int, features: int,
                 shift_clamp: Optional[float] = 1.0):
        super().__init__()
        self.DCN_0 = DCN(cin, features, 3, shift_clamp=shift_clamp)
        self.BatchNorm_0 = batch_norm(features)

    def forward(self, x):
        ms = self.DCN_0.model_shard
        if ms is None or self.BatchNorm_0.model_shard is None:
            return leaky_relu(self.BatchNorm_0(self.DCN_0(x)))
        y = leaky_relu(self.BatchNorm_0.local(self.DCN_0.local(x)))
        return model_axis.gather(y, ms)


class DeformLocConv(nn.Module):
    """Row-banded ("depth-aware") deformable conv -> BN -> LeakyReLU: each
    of `num_rows` horizontal bands has its own learned offsets, mask and
    weights. The offsets and mask come from one grouped conv over the
    band-major channel-folded bands (zero-initialised, so the layer starts
    as 0.5x a per-band plain conv); the bands then sample as a batch
    through `ops.dcn.bilinear_sample` and multiply their own weight
    `[r, KK*C, F]` (row k*C + c: tap k, channel c). No config builds it.
    """

    model_shard = None

    def __init__(self, cin: int, features: int, num_rows: int,
                 kernel: int = 3):
        super().__init__()
        self.num_rows, self.kernel = num_rows, kernel
        KK = kernel * kernel
        self.conv_offset_mask = Conv2d(num_rows * cin, num_rows * 3 * KK,
                                       kernel, padding=0, groups=num_rows)
        self.weight = nn.Parameter(torch.empty(num_rows, KK * cin, features))
        self.bias = nn.Parameter(torch.zeros(num_rows, features))
        self.BatchNorm_0 = batch_norm(features)

    def forward(self, x):
        B, C, H, W = x.shape
        r, K = self.num_rows, self.kernel
        KK, pad, t = K * K, K // 2, H // r
        F_ = self.weight.shape[-1]
        folded = fold_bands(x, r, pad)                  # [B, r*C, t+2p, W+2p]
        om = self.conv_offset_mask(folded).reshape(B, r, 3 * KK, t, W)
        ms = self.model_shard
        if ms is not None:
            folded, om = (model_axis.copy_to(v, ms) for v in (folded, om))
        om = om.permute(0, 1, 3, 4, 2).reshape(B * r, t, W, 3 * KK)
        f32 = torch.float32
        o_y, o_x = om[..., :KK].to(f32), om[..., KK:2 * KK].to(f32)
        mask = torch.sigmoid(om[..., 2 * KK:])
        xb = folded.reshape(B, r, C, t + 2 * pad, W + 2 * pad).permute(
            0, 1, 3, 4, 2).reshape(B * r, t + 2 * pad, W + 2 * pad, C)
        dev = x.device
        ys = torch.arange(t, dtype=f32, device=dev)
        xs = torch.arange(W, dtype=f32, device=dev)
        taps = torch.arange(K, dtype=f32, device=dev)
        tap_y = taps.repeat_interleave(K)
        tap_x = taps.repeat(K)
        py = ys[None, :, None, None] + tap_y + o_y
        px = xs[None, None, :, None] + tap_x + o_x
        sampled = bilinear_sample(xb, py, px)           # [B*r,t,W,KK,C]
        sampled = sampled * mask[..., None].to(x.dtype)
        cols = sampled.reshape(B, r, t * W, KK * C)
        acc = torch.promote_types(x.dtype, f32)
        y = torch.einsum("brnk,rko->brno", cols.to(acc),
                         self.weight.to(x.dtype).to(acc))
        y = (y + self.bias.to(acc)[None, :, None, :]).to(x.dtype)
        y = y.reshape(B, H, W, F_).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        if ms is None:
            return leaky_relu(self.BatchNorm_0(y))
        return model_axis.gather(leaky_relu(self.BatchNorm_0.local(y)), ms)


class PlainConv(nn.Module):
    """3x3 conv used when the necks are not deformable."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.Conv_0 = conv2d(cin, features, 3)

    def forward(self, x):
        return self.Conv_0(x)


class IDAUp(nn.Module):
    """Iterative deep aggregation: for each level i > start,
    level_i = node(up(proj(level_i)) + level_{i-1})."""

    def __init__(self, in_channels: Sequence[int], out_features: int,
                 up_factors: Sequence[int], use_dcn: bool = True,
                 shift_clamp: Optional[float] = 1.0):
        super().__init__()
        if use_dcn:
            conv = lambda cin, f: DeformConv(cin, f, shift_clamp=shift_clamp)
        else:
            conv = PlainConv
        self.n = len(up_factors)
        for j, i in enumerate(range(1, self.n)):
            self.add_module(f"projs_{j}", conv(in_channels[i], out_features))
            self.add_module(f"nodes_{j}", conv(out_features, out_features))
            self.add_module(f"ups_{j}", BilinearUpsample(out_features,
                                                         int(up_factors[i])))

    def forward(self, layers: List[torch.Tensor], start: int, end: int):
        layers = list(layers)
        for i in range(start + 1, end):
            j = i - start - 1
            up = getattr(self, f"ups_{j}")(getattr(self, f"projs_{j}")(layers[i]))
            layers[i] = getattr(self, f"nodes_{j}")(up + layers[i - 1])
        return layers


class DLAUp(nn.Module):
    """The full aggregation pyramid."""

    def __init__(self, channels: Sequence[int], use_dcn: bool = True,
                 shift_clamp: Optional[float] = 1.0):
        super().__init__()
        ch = list(channels)
        in_ch = list(channels)
        scales = [2 ** i for i in range(len(ch))]
        self.n = len(ch) - 1
        for i in range(self.n):
            j = -i - 2
            self.add_module(f"idas_{i}", IDAUp(
                in_ch[j:], ch[j], [s // scales[j] for s in scales[j:]],
                use_dcn=use_dcn, shift_clamp=shift_clamp))
            scales[j + 1:] = [scales[j]] * len(scales[j + 1:])
            in_ch[j + 1:] = [ch[j]] * len(in_ch[j + 1:])

    def forward(self, layers: List[torch.Tensor]):
        layers = list(layers)
        out = [layers[-1]]
        for i in range(self.n):
            start = len(layers) - i - 2
            layers = getattr(self, f"idas_{i}")(layers, start, len(layers))
            out.insert(0, layers[-1])
        return out


class DLASeg(nn.Module):
    """Backbone + DLAUp + final IDAUp -> one stride-`down_ratio` map."""

    def __init__(self, base_name: str = "dla102", down_ratio: int = 8,
                 last_level: int = 5, use_dcn: bool = True,
                 shift_clamp: Optional[float] = 1.0):
        super().__init__()
        self.base, channels = make_dla(base_name)
        self.first_level = int(np.log2(down_ratio))
        self.last_level = last_level
        self.out_channels = channels[self.first_level]
        self.dla_up = DLAUp(channels[self.first_level:], use_dcn=use_dcn,
                            shift_clamp=shift_clamp)
        n_final = last_level - self.first_level
        # DLAUp's i-th output keeps the width of level first_level + i
        self.ida_up = IDAUp(channels[self.first_level:last_level],
                            self.out_channels,
                            [2 ** i for i in range(n_final)],
                            use_dcn=use_dcn, shift_clamp=shift_clamp)

    spatial_shard = None

    def forward(self, images, packed: bool = False):
        """images NHWC (see DLA.forward); returns NCHW (channels_last)."""
        return self.forward_rows(images, packed)[0]

    def forward_rows(self, images, packed: bool = False):
        """(`forward`'s map, whether this forward ran on slabs).

        Under the spatial axis, when every level's height divides by the
        axis, each rank runs its rows and the map is gathered along height
        at the end (the whole map on every rank)."""
        sp = self.spatial_shard
        if sp is None:
            return self._levels(images, packed), False
        H = images.shape[1] * (2 if packed else 1)
        on_slabs = sp.check(H, 2 ** (len(self.base.channels) - 1))
        sp.active = on_slabs
        try:
            y = self._levels(images, packed)
        finally:
            sp.active = False
        return (gather_rows(y, sp), True) if on_slabs else (y, False)

    def _levels(self, images, packed):
        levels = self.base(images, packed=packed)
        agg = self.dla_up(levels[self.first_level:])
        n_final = self.last_level - self.first_level
        y = self.ida_up(list(agg[:n_final]), 0, n_final)
        return y[-1]

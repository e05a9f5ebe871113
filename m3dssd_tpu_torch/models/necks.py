"""DLA aggregation necks: DCN, DeformConv, IDAUp, DLAUp, DLASeg.

Upsampling merges the deep levels into the stride-8 map; the projection and
node convs are deformable (DCNv2 with learned offsets) when `use_dcn` is on,
plain 3x3 convs otherwise. With `shift_clamp` set (the flagship: 1.0) every
deformable layer runs `ops.dcn.dcn_v2_shift`, which on the card is the
hand-written kernel: 8 layers for DLASeg(dla102).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..ops.dcn import dcn_v2, dcn_v2_shift
from .dla import make_dla
from .layers import BilinearUpsample, batch_norm, conv2d, leaky_relu


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

    def forward(self, x):
        KK = self.kernel * self.kernel
        om = self.conv_offset_mask(x).permute(0, 2, 3, 1)     # [B,H,W,3KK]
        offset = torch.stack([om[..., :KK], om[..., KK:2 * KK]], dim=-1)
        mask = torch.sigmoid(om[..., 2 * KK:])
        xh = x.permute(0, 2, 3, 1).contiguous()               # NHWC
        weight = self.weight.to(x.dtype)
        bias = self.bias.to(x.dtype)
        if self.uses_shift:
            y = dcn_v2_shift(xh, offset, mask, weight, bias,
                             clamp=float(self.shift_clamp))
        else:
            y = dcn_v2(xh, offset, mask, weight, bias, stride=self.stride,
                       padding=self.dilation * (self.kernel - 1) // 2,
                       dilation=self.dilation)
        return y.permute(0, 3, 1, 2)                          # channels_last


class DeformConv(nn.Module):
    """DCN -> BN -> LeakyReLU."""

    def __init__(self, cin: int, features: int,
                 shift_clamp: Optional[float] = 1.0):
        super().__init__()
        self.DCN_0 = DCN(cin, features, 3, shift_clamp=shift_clamp)
        self.BatchNorm_0 = batch_norm(features)

    def forward(self, x):
        return leaky_relu(self.BatchNorm_0(self.DCN_0(x)))


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

    def forward(self, images, packed: bool = False):
        """images NHWC (see DLA.forward); returns NCHW (channels_last)."""
        levels = self.base(images, packed=packed)
        agg = self.dla_up(levels[self.first_level:])
        n_final = self.last_level - self.first_level
        y = self.ida_up(list(agg[:n_final]), 0, n_final)
        return y[-1]

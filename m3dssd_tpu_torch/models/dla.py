"""Deep Layer Aggregation backbones (NCHW, channels_last).

BasicBlock / DepthBlock / Bottleneck blocks, recursive Tree/Root
aggregation and the dla34 / dla34_depth / dla60 / dla102 / dla102x
variants. dla34_depth's blocks are row-banded (`LocalConv2d`, 16 bands in
levels 2-5), so its input height must be a multiple of 16 x 32 = 512. The
stem is the plain 7x7 conv at full resolution; images may also arrive
space-to-depth packed and are unpacked by `depth_to_space` first. The
parameters are the same either way.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from ..parallel.spatial import active, local_rows
from .layers import (ConvBNAct, LocalConv2d, batch_norm, conv2d, conv_bn,
                     leaky_relu, max_pool)


class BasicBlock(nn.Module):
    """Two 3x3 convs + residual."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(cin, planes, 3, stride, dilation,
                                     use_bias=True)
        self.ConvBNAct_1 = ConvBNAct(planes, planes, 3, 1, dilation,
                                     use_bias=True, act=False)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        return leaky_relu(self.ConvBNAct_1(self.ConvBNAct_0(x)) + residual)


class DepthBlock(nn.Module):
    """BasicBlock whose second conv is row-banded (`LocalConv2d`)."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dilation: int = 1, num_rows: int = 16):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(cin, planes, 3, stride, dilation)
        self.LocalConv2d_0 = LocalConv2d(planes, num_rows, planes, 3)
        self.BatchNorm_0 = batch_norm(planes)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = self.BatchNorm_0(self.LocalConv2d_0(self.ConvBNAct_0(x)))
        return leaky_relu(out + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck, expansion 2 (cardinality > 1: the
    grouped BottleneckX)."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dilation: int = 1, expansion: int = 2, cardinality: int = 1):
        super().__init__()
        bottle = (planes // expansion if cardinality == 1
                  else planes * cardinality // 32)
        self.ConvBNAct_0 = ConvBNAct(cin, bottle, 1)
        self.Conv_0 = conv2d(bottle, bottle, 3, stride, dilation, bias=False,
                             groups=cardinality)
        self.BatchNorm_0 = batch_norm(bottle)
        self.ConvBNAct_1 = ConvBNAct(bottle, planes, 1, act=False)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = self.ConvBNAct_0(x)
        out = conv_bn(self.Conv_0, self.BatchNorm_0, out, act=True)
        out = self.ConvBNAct_1(out)
        return leaky_relu(out + residual)


class Root(nn.Module):
    """Aggregation node: concat children -> 1x1 conv (+ optional residual)."""

    def __init__(self, cin: int, features: int, residual: bool):
        super().__init__()
        self.Conv_0 = conv2d(cin, features, 1, bias=False)
        self.BatchNorm_0 = batch_norm(features)
        self.residual = residual

    def forward(self, children: List[torch.Tensor]):
        x = conv_bn(self.Conv_0, self.BatchNorm_0, torch.cat(children, dim=1))
        if self.residual:
            x = x + children[0]
        return leaky_relu(x)


class Tree(nn.Module):
    """Recursive hierarchical aggregation."""

    def __init__(self, levels: int, block, in_channels: int,
                 out_channels: int, stride: int = 1, level_root: bool = False,
                 root_dim: int = 0, root_residual: bool = False,
                 dilation: int = 1):
        super().__init__()
        if root_dim == 0:
            root_dim = 2 * out_channels
        if level_root:
            root_dim += in_channels
        self.levels = levels
        self.stride = stride
        self.level_root = level_root
        if levels == 1:
            self.tree1 = block(in_channels, out_channels, stride=stride,
                               dilation=dilation)
            self.tree2 = block(out_channels, out_channels, stride=1,
                               dilation=dilation)
            self.root = Root(root_dim, out_channels, root_residual)
        else:
            self.tree1 = Tree(levels - 1, block, in_channels, out_channels,
                              stride=stride, root_dim=0,
                              root_residual=root_residual, dilation=dilation)
            self.tree2 = Tree(levels - 1, block, out_channels, out_channels,
                              root_dim=root_dim + out_channels,
                              root_residual=root_residual, dilation=dilation)
        self.project = (ConvBNAct(in_channels, out_channels, 1, act=False)
                        if in_channels != out_channels else None)

    def forward(self, x, residual=None, children=None):
        children = [] if children is None else list(children)
        bottom = max_pool(x, self.stride, self.stride) if self.stride > 1 else x
        residual = self.project(bottom) if self.project is not None else bottom
        if self.level_root:
            children.append(bottom)
        x1 = self.tree1(x, residual=residual)
        if self.levels == 1:
            x2 = self.tree2(x1)
            return self.root([x2, x1] + children)
        children.append(x1)
        return self.tree2(x1, children=children)


def depth_to_space(x, C: int):
    """Unpack phase-packed images [B, H/2, W/2, 4C] -> [B, H, W, C] (NHWC).

    Packed channel (2a+b)*C + c holds full-resolution pixel (2i+a, 2j+b, c).
    """
    B, H2, W2, _ = x.shape
    x = x.reshape(B, H2, W2, 2, 2, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, 2 * H2, 2 * W2, C)


def space_to_depth(x):
    """[B, H, W, C] -> [B, H/2, W/2, 4C], the inverse of `depth_to_space`."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // 2, 2, W // 2, 2, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H // 2, W // 2, 4 * C)


class DLA(nn.Module):
    """The DLA trunk: 6 feature levels at strides 1, 2, 4, 8, 16, 32.
    Under an active spatial axis it runs on its rank's rows of the
    images."""

    spatial_shard = None

    def __init__(self, levels: Sequence[int], channels: Sequence[int],
                 block=BasicBlock, residual_root: bool = False,
                 in_channels: int = 3):
        super().__init__()
        ch = list(channels)
        self.levels = list(levels)
        self.channels = ch
        self.in_channels = in_channels
        # compute dtype of a train build whose float32 master weights run
        # in bf16; None: the weights' own dtype
        self.compute_dtype = None
        self.base_conv = conv2d(in_channels, ch[0], 7, bias=False)
        self.base_bn = batch_norm(ch[0])
        # level 0 / level 1 conv stacks; the reference names them
        # ConvBNAct_<n> in order of creation
        n = 0
        self._level01: List[List[str]] = [[], []]
        for i in range(self.levels[0]):
            self.add_module(f"ConvBNAct_{n}", ConvBNAct(ch[0], ch[0], 3, 1))
            self._level01[0].append(f"ConvBNAct_{n}")
            n += 1
        for i in range(self.levels[1]):
            cin = ch[0] if i == 0 else ch[1]
            self.add_module(f"ConvBNAct_{n}",
                            ConvBNAct(cin, ch[1], 3, 2 if i == 0 else 1))
            self._level01[1].append(f"ConvBNAct_{n}")
            n += 1
        self.Tree_0 = Tree(self.levels[2], block, ch[1], ch[2], stride=2,
                           level_root=False, root_residual=residual_root)
        for lvl in range(3, 6):
            self.add_module(f"Tree_{lvl - 2}",
                            Tree(self.levels[lvl], block, ch[lvl - 1],
                                 ch[lvl], stride=2, level_root=True,
                                 root_residual=residual_root))

    def forward(self, images, packed: bool = False) -> List[torch.Tensor]:
        """images: [B, H, W, Cin] (NHWC), or with `packed` their
        space-to-depth packing [B, H/2, W/2, 4*Cin]. Returns the 6 levels
        as NCHW tensors in channels_last memory format."""
        if packed:
            images = depth_to_space(images, self.in_channels)
        sp = active(self.spatial_shard)
        if sp is not None:
            images = local_rows(images, sp, dim=1)
        dtype = self.compute_dtype or self.base_conv.weight.dtype
        x = images.to(dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        x = conv_bn(self.base_conv, self.base_bn, x, act=True)
        outputs = []
        for names in self._level01:
            for name in names:
                x = getattr(self, name)(x)
            outputs.append(x)
        for lvl in range(4):
            x = getattr(self, f"Tree_{lvl}")(x)
            outputs.append(x)
        return outputs


DLA_VARIANTS = {
    "dla34": dict(levels=[1, 1, 1, 2, 2, 1],
                  channels=[16, 32, 64, 128, 256, 512],
                  block=BasicBlock, residual_root=False),
    "dla34_depth": dict(levels=[1, 1, 1, 2, 2, 1],
                        channels=[16, 32, 64, 128, 256, 512],
                        block=DepthBlock, residual_root=False),
    "dla60": dict(levels=[1, 1, 1, 2, 3, 1],
                  channels=[16, 32, 128, 256, 512, 1024],
                  block=Bottleneck, residual_root=False),
    "dla102": dict(levels=[1, 1, 1, 3, 4, 1],
                   channels=[16, 32, 128, 256, 512, 1024],
                   block=Bottleneck, residual_root=True),
    "dla102x": dict(levels=[1, 1, 1, 3, 4, 1],
                    channels=[16, 32, 128, 256, 512, 1024],
                    block=functools.partial(Bottleneck, cardinality=32),
                    residual_root=True),
}


def make_dla(name: str) -> Tuple[DLA, List[int]]:
    if name not in DLA_VARIANTS:
        raise KeyError(f"unknown DLA variant '{name}'; have {sorted(DLA_VARIANTS)}")
    spec = DLA_VARIANTS[name]
    return (DLA(spec["levels"], spec["channels"], spec["block"],
                spec["residual_root"]),
            list(spec["channels"]))

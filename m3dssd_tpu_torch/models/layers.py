"""Shared building blocks (NCHW tensors in channels_last memory format).

Module attribute names follow the reference package's module names
(`Conv_0`, `BatchNorm_0`, ...) so that its parameter trees map onto these
modules mechanically (utils/weights.py). BatchNorm runs in eval mode with
eps 1e-5; LeakyReLU has slope 0.01.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5


def leaky_relu(x):
    return F.leaky_relu(x, negative_slope=0.01)


def batch_norm(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPS, momentum=0.1)


def conv2d(cin: int, cout: int, kernel: int, stride: int = 1,
           dilation: int = 1, bias: bool = True, groups: int = 1) -> nn.Conv2d:
    """'Same' padding for odd kernels, as the reference's explicit pads."""
    pad = dilation * (kernel - 1) // 2
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=pad,
                     dilation=dilation, bias=bias, groups=groups)


class ConvBNAct(nn.Module):
    """Conv -> BatchNorm -> LeakyReLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1, use_bias: bool = False, act: bool = True):
        super().__init__()
        self.Conv_0 = conv2d(cin, cout, kernel, stride, dilation, use_bias)
        self.BatchNorm_0 = batch_norm(cout)
        self.act = act

    def forward(self, x):
        x = self.BatchNorm_0(self.Conv_0(x))
        return leaky_relu(x) if self.act else x


def bilinear_upsample_kernel(f: int, channels: int) -> torch.Tensor:
    """Depthwise ConvTranspose2d weight [C, 1, 2f, 2f] initialised to
    bilinear interpolation."""
    size = 2 * f
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    r = torch.arange(size, dtype=torch.float64)
    w1 = 1 - torch.abs(r / f - c)
    w = (w1[:, None] * w1[None, :]).to(torch.float32)
    return w[None, None].repeat(channels, 1, 1, 1)


class BilinearUpsample(nn.ConvTranspose2d):
    """Learnable depthwise ConvTranspose upsampling by `factor` >= 2,
    bilinear init: ConvTranspose2d(C, C, 2f, stride=f, padding=f//2,
    groups=C). Output size H*f."""

    def __init__(self, channels: int, factor: int):
        if factor < 2:
            raise ValueError(f"upsampling factor {factor} < 2")
        super().__init__(channels, channels, 2 * factor, stride=factor,
                         padding=factor // 2, groups=channels, bias=False)
        with torch.no_grad():
            self.weight.copy_(bilinear_upsample_kernel(factor, channels))


def adaptive_avg_pool2d(x, out_h: int, out_w: int):
    """Output cell i averages rows floor(i*H/o) .. ceil((i+1)*H/o)-1."""
    return F.adaptive_avg_pool2d(x, (out_h, out_w))


def max_pool(x, window: int, stride: int):
    return F.max_pool2d(x, window, stride)

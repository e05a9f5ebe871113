"""Shared building blocks (NCHW tensors in channels_last memory format).

Module attribute names follow the reference package's module names
(`Conv_0`, `BatchNorm_0`, ...) so that its parameter trees map onto these
modules mechanically (utils/weights.py). BatchNorm has eps 1e-5; LeakyReLU
has slope 0.01.

Training follows the reference package's flax modules (`dtype` = compute
type, `param_dtype` = float32): convolutions cast their float32 master
weights to the input's type at use, and BatchNorm in train mode normalises
by the biased batch variance in float32 and moves its running statistics
with momentum 0.9 on that biased variance (torch's own BatchNorm2d updates
them with the unbiased one).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5


BN_MOMENTUM = 0.9   # running-statistics decay, as the reference's flax BN


def leaky_relu(x):
    """LeakyReLU(0.01). Under autograd it is the reference's
    `where(x >= 0, x, 0.01 x)`, whose gradient at exactly 0 is 1 (torch's
    leaky_relu passes the slope there)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return torch.where(x >= 0, x, x * 0.01)
    return F.leaky_relu(x, negative_slope=0.01)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm over NCHW. Eval mode is torch's (running statistics);
    train mode normalises by the batch mean and the biased batch variance
    and updates the running statistics, in float32, as
    r <- 0.9 r + 0.1 stat with the variance E[x^2] - E[x]^2 (clipped at 0)
    the reference's flax BatchNorm keeps.

    On CPU tensors train mode computes the statistics and the normalisation
    in float64: torch's CPU kernel for channels_last inputs (the model's
    layout) sums each channel, forward and backward, in float32 in one
    chain per thread, which moved a CPU train step's updates away from the
    reference's by an amount that changed with the thread count.

    `process_group` (set by `build(group=...)`): in train mode the
    statistics are those of the group's global batch
    (`parallel/sync_bn.py`), with the same running-statistics update on
    every rank.
    """

    process_group = None

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.process_group is not None:
            from ..parallel.sync_bn import GroupBatchNorm

            y, mean, var = GroupBatchNorm.apply(x, self.weight, self.bias,
                                                self.eps, self.process_group)
            self._update_running(mean, var)
            return y
        cpu = x.device.type == "cpu"
        xs = x.double() if cpu else x
        with torch.no_grad():
            xf = xs.detach().to(torch.promote_types(xs.dtype, torch.float32))
            mean = xf.mean((0, 2, 3))
            var = torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean,
                              min=0.0)
            del xf
            self._update_running(mean, var)
        if not cpu:
            return F.batch_norm(x, None, None, self.weight, self.bias,
                                training=True, eps=self.eps)
        mean = xs.mean((0, 2, 3), keepdim=True)
        var = torch.clamp((xs * xs).mean((0, 2, 3), keepdim=True)
                          - mean * mean, min=0.0)
        w = self.weight.double()[None, :, None, None]
        b = self.bias.double()[None, :, None, None]
        return ((xs - mean) * torch.rsqrt(var + self.eps) * w + b).to(x.dtype)

    @torch.no_grad()
    def _update_running(self, mean, var):
        rm, rv = self.running_mean, self.running_var
        rm.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * mean.to(rm.dtype))
        rv.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * var.to(rv.dtype))
        self.num_batches_tracked.add_(1)


def batch_norm(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=BN_EPS, momentum=1.0 - BN_MOMENTUM)


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose weight and bias are cast to the input's dtype at use
    (a no-op where they already have it)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def conv2d(cin: int, cout: int, kernel: int, stride: int = 1,
           dilation: int = 1, bias: bool = True, groups: int = 1) -> Conv2d:
    """'Same' padding for odd kernels, as the reference's explicit pads."""
    pad = dilation * (kernel - 1) // 2
    return Conv2d(cin, cout, kernel, stride=stride, padding=pad,
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


def fold_bands(x, num_rows: int, pad: int):
    """Overlapping row bands of x [B, C, H, W], zero-padded by `pad` on
    each side, folded band-major into channels: [B, r*C, t+2p, W+2p] with
    t = H / r (channel i*C + c is band i's channel c)."""
    B, C, H, W = x.shape
    r = num_rows
    t = H // r
    if t * r != H:
        raise ValueError(f"H={H} not divisible by num_rows={r}")
    xp = F.pad(x, (pad, pad, pad, pad))
    bands = torch.stack([xp[:, :, i * t:i * t + t + 2 * pad]
                         for i in range(r)], dim=1)
    return bands.reshape(B, r * C, t + 2 * pad, W + 2 * pad).contiguous(
        memory_format=torch.channels_last)


class LocalConv2d(nn.Module):
    """Row-banded ("depth-aware") convolution: the image is split into
    `num_rows` horizontal bands, each with its own k x k kernel and bias.
    The bands fold into channel groups (band-major) and run as one grouped
    convolution; the kernel [r*F, C, k, k] holds band i's in rows
    i*F .. (i+1)*F - 1."""

    def __init__(self, cin: int, num_rows: int, features: int,
                 kernel: int = 3):
        super().__init__()
        self.num_rows = num_rows
        self.pad = kernel // 2
        self.Conv_0 = Conv2d(num_rows * cin, num_rows * features, kernel,
                             padding=0, groups=num_rows, bias=True)

    def forward(self, x):
        r = self.num_rows
        y = self.Conv_0(fold_bands(x, r, self.pad))       # [B, r*F, t, W]
        B, RF, t, W = y.shape
        return y.reshape(B, r, RF // r, t, W).transpose(1, 2).reshape(
            B, RF // r, r * t, W).contiguous(memory_format=torch.channels_last)


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

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.to(x.dtype), None,
                                  self.stride, self.padding, 0, self.groups,
                                  self.dilation)


def adaptive_avg_pool2d(x, out_h: int, out_w: int):
    """Output cell i averages rows floor(i*H/o) .. ceil((i+1)*H/o)-1."""
    return F.adaptive_avg_pool2d(x, (out_h, out_w))


def max_pool(x, window: int, stride: int):
    return F.max_pool2d(x, window, stride)

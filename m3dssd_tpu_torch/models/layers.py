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

Under a mesh (`build(mesh=...)`) a layer of DLASeg runs on its rank's rows
(`spatial_shard`, parallel/spatial.py: the halo rows come from the
neighbouring ranks) and a layer with sharded channels runs on its own
output channels (`model_shard`, parallel/model_axis.py); both are None
otherwise.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import model_axis
from ..parallel.spatial import active, conv_halo, halo

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
    model_shard = None

    def forward(self, x):
        ms = self.model_shard
        if ms is None:
            return self.local(x)
        return model_axis.gather(self.local(model_axis.enter(x, ms, True)),
                                 ms)

    def local(self, x):
        """The normalisation of x, whose channels are this layer's own
        (all of them, or its slice under the model axis)."""
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

    model_shard = None
    spatial_shard = None

    def forward(self, x):
        ms = self.model_shard
        if ms is None:
            return self.local(x)
        return model_axis.gather(self.local(self.enter(x)), ms)

    def enter(self, x):
        """x as `local` takes it under the model axis."""
        return model_axis.enter(x, self.model_shard, self.groups > 1)

    def local(self, x):
        """The conv of this layer's own output channels, on this rank's
        rows under the spatial axis."""
        bias = None if self.bias is None else self.bias.to(x.dtype)
        w = self.weight.to(x.dtype)
        groups = self.groups
        if self.model_shard is not None and groups > 1:
            groups //= self.model_shard.size
        padding = self.padding
        sp = active(self.spatial_shard)
        if sp is not None:
            x = halo(x, *conv_halo(self.kernel_size[0], self.stride[0],
                                   padding[0], self.dilation[0]), sp)
            padding = (0, padding[1])
        return F.conv2d(x, w, bias, self.stride, padding, self.dilation,
                        groups)


def conv2d(cin: int, cout: int, kernel: int, stride: int = 1,
           dilation: int = 1, bias: bool = True, groups: int = 1) -> Conv2d:
    """'Same' padding for odd kernels, as the reference's explicit pads."""
    pad = dilation * (kernel - 1) // 2
    return Conv2d(cin, cout, kernel, stride=stride, padding=pad,
                  dilation=dilation, bias=bias, groups=groups)


def conv_bn(conv: Conv2d, bn: BatchNorm2d, x, act: bool = False):
    """bn(conv(x)), with LeakyReLU after it when `act`; under the model
    axis the three run on this rank's channels and gather once."""
    ms = conv.model_shard
    if ms is None or bn.model_shard is None:
        y = bn(conv(x))
        return leaky_relu(y) if act else y
    y = bn.local(conv.local(conv.enter(x)))
    return model_axis.gather(leaky_relu(y) if act else y, ms)


class ConvBNAct(nn.Module):
    """Conv -> BatchNorm -> LeakyReLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1, use_bias: bool = False, act: bool = True):
        super().__init__()
        self.Conv_0 = conv2d(cin, cout, kernel, stride, dilation, use_bias)
        self.BatchNorm_0 = batch_norm(cout)
        self.act = act

    def forward(self, x):
        return conv_bn(self.Conv_0, self.BatchNorm_0, x, self.act)


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
    i*F .. (i+1)*F - 1.

    Under the spatial axis a rank runs the bands its rows cover (picked by
    global row), on its slab with the halo rows; under the model axis its
    F/mp channels of every band (`Conv_0` holds them band-major)."""

    model_shard = None
    spatial_shard = None

    def __init__(self, cin: int, num_rows: int, features: int,
                 kernel: int = 3):
        super().__init__()
        self.num_rows = num_rows
        self.pad = kernel // 2
        self.Conv_0 = Conv2d(num_rows * cin, num_rows * features, kernel,
                             padding=0, groups=num_rows, bias=True)
        self.Conv_0._bands = num_rows

    def forward(self, x):
        r, p = self.num_rows, self.pad
        ms = self.Conv_0.model_shard
        sp = active(self.spatial_shard)
        if ms is None and sp is None:
            y = self.Conv_0(fold_bands(x, r, p))          # [B, r*F, t, W]
            return _unfold_bands(y, r)
        if ms is not None:
            x = model_axis.copy_to(x, ms)
        w, b = self.Conv_0.weight.to(x.dtype), self.Conv_0.bias.to(x.dtype)
        bands, first = r, 0
        if sp is not None:
            if r % sp.size:
                raise ValueError(f"{r} row bands over {sp.size} spatial "
                                 "ranks")
            bands = r // sp.size
            first = sp.index * bands
            F_ = w.shape[0] // r
            w = w[first * F_:(first + bands) * F_]
            b = b[first * F_:(first + bands) * F_]
            xe = halo(x, p, p, sp)
        else:
            xe = F.pad(x, (0, 0, p, p))
        y = F.conv2d(_fold_rows(F.pad(xe, (p, p)), bands, p), w, b,
                     groups=bands)
        y = _unfold_bands(y, bands)
        return model_axis.gather(y, ms) if ms is not None else y


def _fold_rows(xp, num_rows: int, pad: int):
    """Bands of an x [B, C, r*t + 2 pad, W + 2 pad] already padded by `pad`
    on every side, folded band-major into channels (see `fold_bands`)."""
    B, C, Hp, Wp = xp.shape
    t = (Hp - 2 * pad) // num_rows
    bands = torch.stack([xp[:, :, i * t:i * t + t + 2 * pad]
                         for i in range(num_rows)], dim=1)
    return bands.reshape(B, num_rows * C, t + 2 * pad, Wp).contiguous(
        memory_format=torch.channels_last)


def _unfold_bands(y, num_rows: int):
    """[B, r*F, t, W] band-major -> [B, F, r*t, W]."""
    B, RF, t, W = y.shape
    r = num_rows
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

    model_shard = None
    spatial_shard = None

    def forward(self, x):
        ms = self.model_shard
        groups = self.groups
        if ms is not None:
            x = model_axis.enter(x, ms, True)
            groups //= ms.size
        w = self.weight.to(x.dtype)
        sp = active(self.spatial_shard)
        if sp is None:
            y = F.conv_transpose2d(x, w, None, self.stride, self.padding, 0,
                                   groups, self.dilation)
        else:
            # one input row each side; output row j of the slab is row
            # j + p + f of the transposed conv of the extended slab
            f, p = self.stride[0], self.padding[0]
            y = F.conv_transpose2d(halo(x, 1, 1, sp), w, None, self.stride,
                                   (0, self.padding[1]), 0, groups,
                                   self.dilation)
            y = y[:, :, p + f:p + f + f * x.shape[2]]
        return model_axis.gather(y, ms) if ms is not None else y


def adaptive_avg_pool2d(x, out_h: int, out_w: int):
    """Output cell i averages rows floor(i*H/o) .. ceil((i+1)*H/o)-1."""
    return F.adaptive_avg_pool2d(x, (out_h, out_w))


def max_pool(x, window: int, stride: int):
    return F.max_pool2d(x, window, stride)

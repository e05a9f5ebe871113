"""Train-mode BatchNorm over the global batch of a data axis.

Each rank holds its rows of the global batch; the statistics are those of
all rows, so W ranks normalise as one process does on the whole batch:

  forward   one all_reduce of the per-channel [count, sum x, sum x^2]
            (float64); mean = sum x / count, var = sum x^2 / count - mean^2
            (biased, clipped at 0), the variance the reference's flax
            BatchNorm keeps in its running statistics;
  backward  one all_reduce of [sum dy, sum dy * (x - mean)]; dx uses the
            global sums, the scale and bias gradients stay this rank's own
            (the step sums every gradient over the ranks,
            `all_reduce_grads`).

On a card the passes over the activations are torch's fused CUDA
batch-norm primitives, the kernels under torch's SyncBatchNorm:
batch_norm_stats (this rank's mean and biased variance in one Welford
pass, float32 for bf16 input), batch_norm_elemt, batch_norm_backward_reduce
and batch_norm_backward_elemt; the rank's mean and variance become its
[count, sum x, sum x^2] for the all_reduce. On the CPU, where torch has no
such kernels, the arithmetic is float64, as the port's single-process
BatchNorm (`models/layers.py`). torch's SyncBatchNorm itself is not used:
it keeps the unbiased running variance, refuses CPU tensors and gathers
its statistics with all_gather.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_AXES = (0, 2, 3)


def _bcast(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


def _global_moments(sums: torch.Tensor, group):
    """All ranks' (count [1], mean [C], biased variance [C]) from this
    rank's float64 [count, sum x (C), sum x^2 (C)], in one all_reduce."""
    dist.all_reduce(sums, group=group)
    C = (sums.numel() - 1) // 2
    n = sums[:1]
    mean = sums[1:C + 1] / n
    var = torch.clamp(sums[C + 1:] / n - mean * mean, min=0.0)
    return n, mean, var


def _dense(t: torch.Tensor) -> torch.Tensor:
    """t itself when it is contiguous in channels-last order (the model's
    layout), else a contiguous copy: the fused kernels take either."""
    if t.is_contiguous(memory_format=torch.channels_last):
        return t
    return t.contiguous()


class GroupBatchNorm(torch.autograd.Function):
    """y, mean, var = GroupBatchNorm.apply(x, weight, bias, eps, group):
    x [N, C, H, W]; y in x's dtype; mean and var [C], the global batch
    statistics (no gradient flows through them)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        ctx.cuda, ctx.group = x.is_cuda, group
        C = x.shape[1]
        count = x.numel() // C
        if x.is_cuda:
            x = _dense(x)
            # eps 0: this rank's own biased variance, invstd 0 where it is 0
            mean, invstd = torch.batch_norm_stats(x, 0.0)
            m = mean.double()
            var = invstd.double().pow(-2).nan_to_num_(posinf=0.0)
            n, gmean, gvar = _global_moments(
                torch.cat([m.new_ones(1), m, var + m * m]) * count, group)
            ct = mean.dtype
            mean, invstd = gmean.to(ct), torch.rsqrt(gvar + eps).to(ct)
            w = weight.to(ct)
            y = torch.batch_norm_elemt(x, w, bias.to(ct), mean, invstd, eps)
            ctx.save_for_backward(x, w, mean, invstd, n.to(torch.int32))
        else:
            xs = x.double()
            n, gmean, gvar = _global_moments(
                torch.cat([xs.new_full((1,), float(count)), xs.sum(_AXES),
                           (xs * xs).sum(_AXES)]), group)
            invstd = torch.rsqrt(gvar + eps)
            y = ((xs - _bcast(gmean)) * _bcast(invstd)
                 * _bcast(weight.double()) + _bcast(bias.double())).to(x.dtype)
            ctx.save_for_backward(x, weight, gmean, invstd, n)
        ctx.mark_non_differentiable(gmean, gvar)
        return y, gmean, gvar

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, n = ctx.saved_tensors
        C = x.shape[1]
        if ctx.cuda:
            need_x, need_w, need_b = ctx.needs_input_grad[:3]
            dy = (dy.contiguous(memory_format=torch.channels_last)
                  if x.is_contiguous(memory_format=torch.channels_last)
                  else dy.contiguous())
            sum_dy, sum_dyxmu, dweight, dbias = \
                torch.batch_norm_backward_reduce(dy, x, mean, invstd, weight,
                                                 need_x, need_w, need_b)
            dx = None
            if need_x:
                sums = torch.cat([sum_dy, sum_dyxmu])
                dist.all_reduce(sums, group=ctx.group)
                dx = torch.batch_norm_backward_elemt(
                    dy, x, mean, invstd, weight, sums[:C], sums[C:], n)
            return dx, dweight, dbias, None, None
        xhat = (x.double() - _bcast(mean)) * _bcast(invstd)
        dyc = dy.double()
        local = torch.cat([dyc.sum(_AXES), (dyc * xhat).sum(_AXES)])
        sums = local.clone()
        dist.all_reduce(sums, group=ctx.group)
        g_dy, g_dyx = sums[:C] / n, sums[C:] / n
        dx = (dyc - _bcast(g_dy) - xhat * _bcast(g_dyx)) \
            * _bcast(invstd * weight.double())
        dweight = local[C:].to(weight.dtype)
        dbias = local[:C].to(weight.dtype)
        return dx.to(x.dtype), dweight, dbias, None, None

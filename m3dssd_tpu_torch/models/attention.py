"""ANAB: the asymmetric non-local attention block on the depth branch, and
the non-local modules no config builds: NLUp (cross-resolution position
attention) and NLPM (ANAB without the spatial gates).

The query stays at full resolution; keys and values are pyramid-pooled to
S = sum(s^2) tokens (337 for sizes 1/4/8/16), so attention costs
O(HW * S). Per-scale sigmoid gates multiply the features before each
pooling level (PAPA).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from .layers import adaptive_avg_pool2d, batch_norm, conv2d


def papa_pool(feats, atten: Optional[torch.Tensor], sizes: Sequence[int]):
    """Pyramid adaptive pooling with optional per-scale spatial attention.

    feats [B,C,H,W]; atten [B,len(sizes),H,W] or None.
    Returns [B, S, C] with S = sum(s^2), tokens in row-major cell order.
    """
    tokens = []
    for i, s in enumerate(sizes):
        f = feats if atten is None else feats * atten[:, i:i + 1]
        p = adaptive_avg_pool2d(f, s, s)                   # [B,C,s,s]
        tokens.append(p.flatten(2).transpose(1, 2))        # [B,s*s,C]
    return torch.cat(tokens, dim=1)


class ANAB(nn.Module):
    """Asymmetric non-local attention; key width = (sum s^2) // 2."""

    def __init__(self, channels: int, psp_sizes: Sequence[int] = (1, 4, 8, 16),
                 with_atten: bool = True):
        super().__init__()
        self.psp_sizes = tuple(psp_sizes)
        key_ch = sum(s * s for s in self.psp_sizes) // 2
        self.query_conv = conv2d(channels, key_ch, 1, bias=False)
        self.spatial_conv = (conv2d(channels, len(self.psp_sizes), 1,
                                    bias=False) if with_atten else None)
        self.key_conv = conv2d(channels, key_ch, 1, bias=False)
        self.value_conv = conv2d(channels, channels, 1, bias=False)

    def forward(self, x):
        B, C, H, W = x.shape
        query = self.query_conv(x).permute(0, 2, 3, 1).reshape(B, H * W, -1)
        atten = (torch.sigmoid(self.spatial_conv(x))
                 if self.spatial_conv is not None else None)
        key = papa_pool(self.key_conv(x), atten, self.psp_sizes)  # [B,S,kc]
        value = papa_pool(self.value_conv(x), atten, self.psp_sizes)
        att = torch.matmul(query, key.transpose(1, 2))            # [B,HW,S]
        att = torch.softmax(att.to(torch.float32), dim=-1).to(x.dtype)
        out = torch.matmul(att, value)                            # [B,HW,C]
        return out.reshape(B, H, W, C).permute(0, 3, 1, 2) + x


def _tokens(x):
    """[B, C, H, W] -> [B, H*W, C], row-major positions."""
    return x.flatten(2).transpose(1, 2)


class NLUp(nn.Module):
    """Cross-resolution position attention between a query map q [B, Cq,
    qh, qw] and a (possibly coarser) value map v [B, Cv, vh, vw]: full
    O(qh*qw x vh*vw) attention over BatchNorm-ed queries and keys, softmax
    in float32. `v_channels != q_channels` adds 1x1 key and value convs."""

    def __init__(self, q_channels: int, v_channels: int):
        super().__init__()
        if v_channels != q_channels:
            self.k_conv = conv2d(v_channels, q_channels, 1, bias=False)
            self.v_conv = conv2d(v_channels, q_channels, 1, bias=False)
        else:
            self.k_conv = self.v_conv = None
        self.q_bn = batch_norm(q_channels)
        self.k_bn = batch_norm(q_channels)

    def forward(self, q, v):
        B, C, qh, qw = q.shape
        if self.k_conv is not None:
            key, value = self.k_conv(v), self.v_conv(v)
        else:
            key, value = v, v
        qf = _tokens(self.q_bn(q))
        kf = _tokens(self.k_bn(key))
        att = torch.matmul(qf, kf.transpose(1, 2))            # [B, Q, S]
        att = torch.softmax(att.to(torch.float32), dim=-1).to(q.dtype)
        out = torch.matmul(att, _tokens(value))               # [B, Q, C]
        return out.transpose(1, 2).reshape(B, C, qh, qw).contiguous(
            memory_format=torch.channels_last)


class NLPM(nn.Module):
    """Non-local pyramid module: ANAB's pyramid-pooled attention without the
    spatial gates, with its own key and output widths (`residual` needs
    out_features == channels)."""

    def __init__(self, channels: int, out_features: int, key_features: int,
                 psp_sizes: Sequence[int] = (1, 4, 8, 16),
                 residual: bool = True):
        super().__init__()
        self.psp_sizes = tuple(psp_sizes)
        self.residual = residual
        self.Conv_0 = conv2d(channels, key_features, 1, bias=False)
        self.Conv_1 = conv2d(channels, key_features, 1, bias=False)
        self.Conv_2 = conv2d(channels, out_features, 1, bias=False)

    def forward(self, x):
        B, C, H, W = x.shape
        q = _tokens(self.Conv_0(x))
        k = papa_pool(self.Conv_1(x), None, self.psp_sizes)
        v = papa_pool(self.Conv_2(x), None, self.psp_sizes)
        att = torch.softmax(torch.matmul(q, k.transpose(1, 2))
                            .to(torch.float32), dim=-1).to(x.dtype)
        out = torch.matmul(att, v)
        out = out.transpose(1, 2).reshape(B, -1, H, W).contiguous(
            memory_format=torch.channels_last)
        return out + x if self.residual else out

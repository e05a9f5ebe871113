"""ANAB: the asymmetric non-local attention block on the depth branch.

The query stays at full resolution; keys and values are pyramid-pooled to
S = sum(s^2) tokens (337 for sizes 1/4/8/16), so attention costs
O(HW * S). Per-scale sigmoid gates multiply the features before each
pooling level (PAPA).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from .layers import adaptive_avg_pool2d, conv2d


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

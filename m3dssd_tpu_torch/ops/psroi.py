"""Deformable position-sensitive RoI pooling (DCNv2Pooling), plain
PyTorch: the reference package's `ops/psroi.py`, which re-derives the
upstream CUDA op. No part of the M3DSSD graph uses it (API-surface
parity).

Each RoI is divided into pooled_size^2 bins; each bin averages
`sample_per_part`^2 bilinear samples from its (optionally offset)
position, reading the channel group of its bin (position-sensitive).
"""

from __future__ import annotations

import torch

from .dcn import bilinear_sample


def dcn_v2_psroi_pooling(x, rois, offset, *, spatial_scale: float,
                         pooled_size: int, output_dim: int,
                         no_trans: bool = False, group_size: int = 1,
                         part_size: int = None, sample_per_part: int = 4,
                         trans_std: float = 0.0):
    """x [1, H, W, C] (C = output_dim * group_size^2); rois [R, 5] =
    [batch_idx, x1, y1, x2, y2]; offset [R, part^2, 2] or empty.
    Returns pooled [R, pooled_size, pooled_size, output_dim]."""
    part_size = part_size or pooled_size
    R = rois.shape[0]
    P = pooled_size
    S = sample_per_part
    C = x.shape[-1]
    if C != output_dim * group_size * group_size:
        raise ValueError(f"{C} channels for output_dim {output_dim} and "
                         f"group_size {group_size}")
    dev = x.device
    x1 = rois[:, 1] * spatial_scale - 0.5
    y1 = rois[:, 2] * spatial_scale - 0.5
    x2 = (rois[:, 3] + 1.0) * spatial_scale - 0.5
    y2 = (rois[:, 4] + 1.0) * spatial_scale - 0.5
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    bin_w, bin_h = rw / P, rh / P
    sub_w, sub_h = bin_w / S, bin_h / S

    iy = torch.arange(P, device=dev)
    ix = torch.arange(P, device=dev)
    s = torch.arange(S, device=dev)

    # sample grid [R, P(i), P(j), s(y), s(x)]
    row = y1[:, None] + iy[None, :] * bin_h[:, None]          # [R, P]
    col = x1[:, None] + ix[None, :] * bin_w[:, None]          # [R, P]
    base_y = (row[:, :, None, None, None]
              + (s + 0.5)[None, None, None, :, None]
              * sub_h[:, None, None, None, None])
    base_x = (col[:, None, :, None, None]
              + (s + 0.5)[None, None, None, None, :]
              * sub_w[:, None, None, None, None])
    base_y = base_y.expand(R, P, P, S, S)
    base_x = base_x.expand(R, P, P, S, S)

    if not no_trans and offset is not None and offset.numel():
        # per-part learned offsets scaled by the RoI's size (trans_std)
        py = (iy * part_size) // P
        px = (ix * part_size) // P
        off = offset[:, py[:, None] * part_size + px[None, :]]  # [R,P,P,2]
        base_y = base_y + (off[..., 0] * trans_std
                           * rh[:, None, None])[..., None, None]
        base_x = base_x + (off[..., 1] * trans_std
                           * rw[:, None, None])[..., None, None]

    sampled = bilinear_sample(x, base_y.reshape(1, -1),
                              base_x.reshape(1, -1))     # [1, R*P*P*S*S, C]
    pooled_all = sampled.reshape(R, P, P, S * S, C).mean(dim=3)

    # position-sensitive channels: bin (i, j) reads group (gy, gx)
    gy = torch.clamp((iy * group_size) // P, 0, group_size - 1)
    gx = torch.clamp((ix * group_size) // P, 0, group_size - 1)
    gidx = gy[:, None] * group_size + gx[None, :]             # [P, P]
    chan = gidx[..., None] * output_dim + torch.arange(output_dim,
                                                       device=dev)
    return torch.gather(pooled_all, -1,
                        chan[None].expand(R, P, P, output_dim))

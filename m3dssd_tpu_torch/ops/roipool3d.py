"""RoI pooling of 3D points inside rotated 3D boxes, plain PyTorch: the
reference package's `ops/roipool3d.py` (its re-derivation of PointRCNN's
roipool3d extension). The main M3DSSD path does not use it.

Membership is a mask. Pooling keeps each box's member points in index
order and pads with zeros to `sampled_pts_num`; the upstream kernel
repeats the first point instead, a deviation the reference documents
and the port keeps.
"""

from __future__ import annotations

import torch


def pts_in_boxes3d(pts, boxes3d, eps=1e-6):
    """pts [P, 3] camera coords; boxes3d [B, 7] = [x, y, z, h, w, l, ry]
    (y the bottom). Returns bool [B, P]."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    cx, by, cz = (boxes3d[:, i][:, None] for i in range(3))
    h, w, l, ry = (boxes3d[:, i][:, None] for i in range(3, 7))
    in_y = (y[None] <= by + eps) & (y[None] >= by - h - eps)
    # into the box frame (yaw about the camera's Y)
    dx = x[None] - cx
    dz = z[None] - cz
    ca, sa = torch.cos(ry), torch.sin(ry)
    lx = ca * dx - sa * dz          # along the box's length
    lz = sa * dx + ca * dz          # along its width
    in_l = torch.abs(lx) <= l / 2 + eps
    in_w = torch.abs(lz) <= w / 2 + eps
    return in_y & in_l & in_w


def roipool3d(pts, pts_feature, boxes3d, pool_extra_width=1.0,
              sampled_pts_num: int = 512):
    """Pool up to `sampled_pts_num` points (xyz + features) per enlarged
    box. pts [P, 3]; pts_feature [P, C]; boxes3d [B, 7]. Returns (pooled
    [B, min(S, P), 3 + C], empty_flag bool [B])."""
    mask = pts_in_boxes3d(pts, enlarge_box3d(boxes3d, pool_extra_width))
    feat = torch.cat([pts, pts_feature], dim=1)               # [P, 3+C]
    P = mask.shape[1]
    # member points first, by index; the rest after
    idx = torch.arange(P, device=pts.device)
    key = torch.where(mask, idx[None], torch.full_like(idx[None], P + 1))
    take = torch.argsort(key, dim=1, stable=True)[:, :sampled_pts_num]
    valid = torch.gather(mask, 1, take)
    pooled = feat[take] * valid[..., None].to(feat.dtype)
    return pooled, ~mask.any(dim=1)


def enlarge_box3d(boxes3d, extra_width=1.0):
    """Enlarge boxes by `extra_width` on every side (the bottom y moves
    down by it, so the box stays centred)."""
    out = boxes3d.clone()
    out[:, 3:6] += extra_width * 2
    out[:, 1] += extra_width
    return out

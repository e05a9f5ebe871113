"""Channel-major box decoding (every operand keeps N, the anchors, last)
and the loss's box helpers.

Where the reference package's loss has a max, min or clip, these use
torch.maximum / torch.minimum, whose gradient at a tie splits 0.5 as JAX's
does (torch.clamp passes the whole gradient at its bounds).
"""

from __future__ import annotations

import math

import torch


def clip(x, lo=None, hi=None):
    """jnp.clip with JAX's gradient: 0.5 to each side at a bound."""
    if lo is not None:
        x = torch.maximum(x, torch.full_like(x, lo))
    if hi is not None:
        x = torch.minimum(x, torch.full_like(x, hi))
    return x


def bbox_transform_inv_t(rois_t, deltas_t, means=None, stds=None):
    """Decode whitened [dx,dy,dw,dh] against rois.

    rois_t [4+, N]; deltas_t [..., 4, N] -> [..., 4, N] as (x1, y1, x2, y2).
    """
    w = rois_t[2] - rois_t[0] + 1.0
    h = rois_t[3] - rois_t[1] + 1.0
    cx = rois_t[0] + 0.5 * w
    cy = rois_t[1] + 0.5 * h

    dx, dy, dw, dh = (deltas_t[..., 0, :], deltas_t[..., 1, :],
                      deltas_t[..., 2, :], deltas_t[..., 3, :])
    if stds is not None:
        dx = dx * stds[0]; dy = dy * stds[1]; dw = dw * stds[2]; dh = dh * stds[3]
    if means is not None:
        dx = dx + means[0]; dy = dy + means[1]; dw = dw + means[2]; dh = dh + means[3]

    pcx = dx * w + cx
    pcy = dy * h + cy
    pw = torch.exp(dw) * w
    ph = torch.exp(dh) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                        pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-2)


def decode_bbox_3d_t(rois_t, deltas_t, anchors3d_t, means, stds):
    """Channel-major 3D decode.

    rois_t [4+, N]; deltas_t [..., 7, N] whitened (x, y, z, w, h, l, ry);
    anchors3d_t [5, N] per-roi (z, w3, h3, l3, alpha) priors; means/stds
    [11] whitening stats (3D slots 4..10). Returns [..., 7, N] =
    (x2d, y2d, z, w3, h3, l3, alpha).
    """
    d = deltas_t * stds[4:11, None] + means[4:11, None]
    w = rois_t[2] - rois_t[0] + 1.0
    h = rois_t[3] - rois_t[1] + 1.0
    cx = rois_t[0] + 0.5 * w
    cy = rois_t[1] + 0.5 * h

    x2d = d[..., 0, :] * w + cx
    y2d = d[..., 1, :] * h + cy
    z = anchors3d_t[0] + d[..., 2, :]
    w3 = torch.exp(d[..., 3, :]) * anchors3d_t[1]
    h3 = torch.exp(d[..., 4, :]) * anchors3d_t[2]
    l3 = torch.exp(d[..., 5, :]) * anchors3d_t[3]
    ry = anchors3d_t[4] + d[..., 6, :]
    return torch.stack([x2d, y2d, z, w3, h3, l3, ry], dim=-2)


def iou_list_t(a_t, b_t, eps: float = 1e-8):
    """Elementwise IoU of channel-major box arrays [..., 4, N] -> [..., N]."""
    ix1 = torch.maximum(a_t[..., 0, :], b_t[..., 0, :])
    iy1 = torch.maximum(a_t[..., 1, :], b_t[..., 1, :])
    ix2 = torch.minimum(a_t[..., 2, :], b_t[..., 2, :])
    iy2 = torch.minimum(a_t[..., 3, :], b_t[..., 3, :])
    inter = clip(ix2 - ix1, 0.0) * clip(iy2 - iy1, 0.0)
    area_a = (a_t[..., 2, :] - a_t[..., 0, :]) * (a_t[..., 3, :] - a_t[..., 1, :])
    area_b = (b_t[..., 2, :] - b_t[..., 0, :]) * (b_t[..., 3, :] - b_t[..., 1, :])
    return inter / (area_a + area_b - inter + eps)


def convert_alpha_to_rot(alpha, z3d, x3d):
    """alpha -> rotY on the viewing ray, wrapped to (-pi, pi]."""
    ry = alpha + torch.atan2(-z3d, x3d) + 0.5 * math.pi
    return ry - torch.round(ry / (2 * math.pi)) * 2 * math.pi


def backproject(p2_inv, x2d, y2d, z):
    """Camera coordinates [..., 4] of image points (x2d, y2d) at depth z;
    p2_inv [..., 4, 4] broadcasts against the points."""
    pts = torch.stack([x2d * z, y2d * z, z, torch.ones_like(z)], dim=-1)
    return torch.einsum("...ij,...j->...i", p2_inv, pts)


def smooth_l1(pred, target):
    """Huber / smooth-L1 with beta 1."""
    d = torch.abs(pred - target)
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def masked_mean(x, mask, count=None, eps: float = 1e-12):
    """sum(x * mask) / count, with a safe denominator; `count` defaults to
    sum(mask) (a data-parallel loss passes the global batch's)."""
    m = mask.to(x.dtype)
    if count is None:
        count = torch.sum(m)
    return torch.sum(x * m) / torch.clamp(count, min=eps)

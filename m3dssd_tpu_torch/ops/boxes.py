"""Channel-major box decoding: every operand keeps N (the anchors) last."""

from __future__ import annotations

import torch


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

"""Rotated BEV / 3D IoU, 3D GIoU and rotated-BEV NMS as fixed-shape torch
ops (the port's counterpart of the reference package's `ops/iou3d.py`).

Box format (camera frame): boxes3d [N,7] = [x, y, z, h, w, l, ry] with y
the bottom face; the BEV rbox is [cx, cz, w, l, angle].

The rotated intersection takes 24 candidate points per pair (the corners
of each box inside the other and the 16 edge crossings), orders the valid
ones by angle about their centroid and sums the fan of triangles from the
first. Gradients flow through the vertex coordinates; the angles and the
centroid only choose the order and are computed outside autograd.
"""

from __future__ import annotations

import torch

from .boxes import clip


def boxes3d_to_bev(boxes3d):
    """[..., 7] camera boxes -> [..., 5] BEV rboxes [cx, cz, w, l, angle]."""
    return torch.stack([boxes3d[..., 0], boxes3d[..., 2], boxes3d[..., 4],
                        boxes3d[..., 5], boxes3d[..., 6]], dim=-1)


def _rbbox_corners(rb):
    """[..., 5] -> [..., 4, 2] clockwise corners (x along the box 'w' axis)."""
    cx, cy, xd, yd, a = rb.unbind(-1)
    ca, sa = torch.cos(a), torch.sin(a)
    lx = torch.stack([-xd / 2, -xd / 2, xd / 2, xd / 2], dim=-1)
    ly = torch.stack([-yd / 2, yd / 2, yd / 2, -yd / 2], dim=-1)
    x = ca[..., None] * lx + sa[..., None] * ly + cx[..., None]
    y = -sa[..., None] * lx + ca[..., None] * ly + cy[..., None]
    return torch.stack([x, y], dim=-1)


def _abs(x):
    """|x| with JAX's gradient at 0 (+1; torch.abs passes 0 there)."""
    return torch.where(x >= 0, x, -x)


def _cross(o, a, b):
    return ((a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1])
            - (a[..., 1] - o[..., 1]) * (b[..., 0] - o[..., 0]))


def _points_in_quad(pts, corners):
    """pts [..., P, 2] inside the parallelogram `corners` [..., 4, 2], with
    a relative tolerance of 1e-4 of each edge's squared length (coincident
    corners carry ~1e-6 relative error in float32)."""
    A = corners[..., 0:1, :]
    ab = corners[..., 1:2, :] - A
    ad = corners[..., 3:4, :] - A
    ap = pts - A
    abab = (ab * ab).sum(-1)
    abap = (ab * ap).sum(-1)
    adad = (ad * ad).sum(-1)
    adap = (ad * ap).sum(-1)
    e1 = 1e-4 * abab
    e2 = 1e-4 * adad
    return ((abab - abap >= -e1) & (abap >= -e1)
            & (adad - adap >= -e2) & (adap >= -e2))


def _pairwise_intersection_area(c1, c2):
    """c1, c2: [..., 4, 2] corner sets -> intersection areas [...]."""
    in12 = _points_in_quad(c1, c2)
    in21 = _points_in_quad(c2, c1)

    a = c1[..., :, None, :]
    b = torch.roll(c1, -1, dims=-2)[..., :, None, :]
    c = c2[..., None, :, :]
    d = torch.roll(c2, -1, dims=-2)[..., None, :, :]
    area_abc = _cross(a, b, c)
    area_abd = _cross(a, b, d)
    area_cda = _cross(c, d, a)
    area_cdb = area_cda + area_abc - area_abd
    valid = (area_abc * area_abd < 0) & (area_cda * area_cdb < 0)
    denom = area_abd - area_abc
    # the inner where keeps a zero denominator out of the division, whose
    # gradient would otherwise reach the untaken branch as 0 * inf
    t = torch.where(torch.abs(denom) > 1e-12,
                    area_cda / torch.where(denom == 0,
                                           torch.ones_like(denom), denom),
                    torch.zeros_like(denom))
    xpts = a + t[..., None] * (b - a)
    lead = xpts.shape[:-3]
    xpts = xpts.reshape(lead + (16, 2))
    valid = valid.reshape(lead + (16,))

    pts = torch.cat([c1, c2, xpts], dim=-2)                # [..., 24, 2]
    vmask = torch.cat([in12, in21, valid], dim=-1)
    cnt = vmask.sum(-1)
    with torch.no_grad():
        w = vmask.to(pts.dtype)
        centroid = ((pts * w[..., None]).sum(-2)
                    / torch.clamp(cnt, min=1)[..., None].to(pts.dtype))
        ang = torch.atan2(pts[..., 1] - centroid[..., None, 1],
                          pts[..., 0] - centroid[..., None, 0])
        ang = torch.where(vmask, ang, torch.full_like(ang, float("inf")))
        order = torch.argsort(ang, dim=-1, stable=True)
    sp = torch.take_along_dim(pts, order[..., None], dim=-2)
    p0 = sp[..., 0:1, :]
    tri = _abs(_cross(p0, sp[..., 1:-1, :], sp[..., 2:, :])) / 2.0
    idx = torch.arange(tri.shape[-1], device=tri.device)
    tv = idx < torch.clamp(cnt[..., None] - 2, min=0)
    return (tri * tv).sum(-1)


def _pair_corners(boxes_a, boxes_b):
    """BEV rboxes and [M, N, 4, 2] corner sets of every (a, b) pair."""
    ra = boxes3d_to_bev(boxes_a)
    rb = boxes3d_to_bev(boxes_b)
    M, N = ra.shape[0], rb.shape[0]
    ca = _rbbox_corners(ra)[:, None].expand(M, N, 4, 2)
    cb = _rbbox_corners(rb)[None, :].expand(M, N, 4, 2)
    return ra, rb, ca, cb


def boxes_iou_bev(boxes_a, boxes_b):
    """Pairwise rotated BEV IoU: [M,7] x [N,7] camera boxes -> [M,N]."""
    ra, rb, ca, cb = _pair_corners(boxes_a, boxes_b)
    inter = _pairwise_intersection_area(ca, cb)
    area_a = (ra[:, 2] * ra[:, 3])[:, None]
    area_b = (rb[:, 2] * rb[:, 3])[None, :]
    return inter / clip(area_a + area_b - inter, 1e-7)


def boxes_iou3d(boxes_a, boxes_b):
    """Pairwise 3D IoU: [M,7] x [N,7] camera boxes -> [M,N]."""
    _, _, ca, cb = _pair_corners(boxes_a, boxes_b)
    inter_bev = _pairwise_intersection_area(ca, cb)
    # vertical: y is the bottom; a box extends upward (decreasing y) by h
    ymax = torch.minimum(boxes_a[:, 1][:, None], boxes_b[:, 1][None, :])
    ymin = torch.maximum((boxes_a[:, 1] - boxes_a[:, 3])[:, None],
                         (boxes_b[:, 1] - boxes_b[:, 3])[None, :])
    ih = clip(ymax - ymin, 0.0)
    inter = inter_bev * ih
    vol_a = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vol_b = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None, :]
    return inter / clip(vol_a + vol_b - inter, 1e-7)


def giou_3d(boxes_a, boxes_b):
    """Elementwise 3D GIoU of boxes [N,7] paired row by row; returns
    (giou [N], iou3d [N]).

    The overlap is the exact rotated intersection; the enclosing hull is
    the axis-aligned bound of both boxes' rotated corners times the full
    height span, so giou(a, a) == 1 only for axis-aligned boxes (a rotated
    box reaches 1 - aabb_gap / hull), as in the reference package.
    """
    if boxes_a.shape != boxes_b.shape:
        raise ValueError(f"giou_3d pairs rows: {tuple(boxes_a.shape)} vs "
                         f"{tuple(boxes_b.shape)}")
    ca = _rbbox_corners(boxes3d_to_bev(boxes_a))
    cb = _rbbox_corners(boxes3d_to_bev(boxes_b))
    inter_bev = _pairwise_intersection_area(ca, cb)
    ya, yb = boxes_a[:, 1], boxes_b[:, 1]
    ta, tb = ya - boxes_a[:, 3], yb - boxes_b[:, 3]
    ih = clip(torch.minimum(ya, yb) - torch.maximum(ta, tb), 0.0)
    inter = inter_bev * ih
    vol_a = boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5]
    vol_b = boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5]
    union = vol_a + vol_b - inter
    iou = inter / clip(union, 1e-7)

    allc = torch.cat([ca, cb], dim=-2)
    # amax / amin share the gradient among tied corners, as JAX's max does
    hull_wl = allc.amax(-2) - allc.amin(-2)                 # [N, 2]
    hull_h = torch.maximum(ya, yb) - torch.minimum(ta, tb)
    hull_vol = hull_wl[:, 0] * hull_wl[:, 1] * hull_h
    giou = iou - (hull_vol - union) / clip(hull_vol, 1e-7)
    return giou, iou


def nms_bev(boxes3d, scores, thresh, num_out: int):
    """Rotated-BEV greedy NMS, select-style: `num_out` rounds, each taking
    the highest active score and suppressing every box whose BEV IoU with
    it exceeds `thresh`. Runs on the boxes' device without a host sync.

    Returns (indices [num_out] int32, valid [num_out] bool)."""
    dev = boxes3d.device
    if num_out == 0:
        return (torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))
    rb = boxes3d_to_bev(boxes3d)
    corners = _rbbox_corners(rb)                             # [N,4,2]
    area = rb[:, 2] * rb[:, 3]
    N = rb.shape[0]
    active = scores.to(torch.float32).clone()
    neg_inf = torch.full((), float("-inf"), dtype=torch.float32, device=dev)
    ar = torch.arange(N, device=dev)
    idxs, valid = [], []
    for _ in range(num_out):
        i = torch.argmax(active)
        ok = active[i] > neg_inf
        idxs.append(i.to(torch.int32))
        valid.append(ok)
        ci = corners[i].expand_as(corners)
        inter = _pairwise_intersection_area(ci, corners)
        iou = inter / clip(area[i] + area - inter, 1e-7)
        suppress = (iou > thresh) | (ar == i)
        active = torch.where(ok & suppress, neg_inf, active)
    return torch.stack(idxs), torch.stack(valid)

"""Rotated (BEV) rectangle IoU — vectorized numpy.

Replaces the reference's numba.cuda kernels (ref:lib/eval/rotate_iou.py:
rbbox_to_corners :204, quadrilateral_intersection :180, inter :231,
devRotateIoUEval :248). The intersection area of two rotated rectangles is
computed the same way — corners-inside tests + all 16 edge-pair crossings,
sorted around the centroid, fan-triangulated — but batched over all (N, K)
pairs at once instead of one CUDA thread per pair.

Box format: [center_x, center_y, x_size, y_size, angle] with the clockwise
corner convention of the reference kernel.
The port's own copy.
"""

from __future__ import annotations

import numpy as np


def rbbox_corners(rbbox):
    """[...,5] -> [...,4,2] clockwise corners (ref:rotate_iou.py:204-227)."""
    rbbox = np.asarray(rbbox, dtype=np.float64)
    cx, cy = rbbox[..., 0], rbbox[..., 1]
    xd, yd = rbbox[..., 2], rbbox[..., 3]
    a = rbbox[..., 4]
    ca, sa = np.cos(a), np.sin(a)
    lx = np.stack([-xd / 2, -xd / 2, xd / 2, xd / 2], axis=-1)
    ly = np.stack([-yd / 2, yd / 2, yd / 2, -yd / 2], axis=-1)
    x = ca[..., None] * lx + sa[..., None] * ly + cx[..., None]
    y = -sa[..., None] * lx + ca[..., None] * ly + cy[..., None]
    return np.stack([x, y], axis=-1)


def _points_in_quad(pts, corners):
    """pts [..., P, 2] inside convex quad corners [..., 4, 2]?

    Dot-product containment test with inclusive bounds
    (ref:rotate_iou.py:161-178 point_in_quadrilateral).
    """
    A = corners[..., 0:1, :]
    ab = corners[..., 1:2, :] - A
    ad = corners[..., 3:4, :] - A
    ap = pts - A
    abab = (ab * ab).sum(-1)
    abap = (ab * ap).sum(-1)
    adad = (ad * ad).sum(-1)
    adap = (ad * ap).sum(-1)
    # scale-aware tolerance so exactly-coincident corners count as inside
    e1 = 1e-9 * abab
    e2 = 1e-9 * adad
    return ((abab - abap >= -e1) & (abap >= -e1)
            & (adad - adap >= -e2) & (adap >= -e2))


def _cross(o, a, b):
    return ((a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1])
            - (a[..., 1] - o[..., 1]) * (b[..., 0] - o[..., 0]))


def _edge_intersections(c1, c2):
    """All 16 edge-pair crossing points of two quads.

    c1, c2: [..., 4, 2]. Returns pts [..., 16, 2], valid [..., 16] using the
    strict double-sided sign test of ref:rotate_iou.py:122-158.
    """
    a = c1[..., :, None, :]                       # [..., 4, 1, 2]
    b = np.roll(c1, -1, axis=-2)[..., :, None, :]
    c = c2[..., None, :, :]                       # [..., 1, 4, 2]
    d = np.roll(c2, -1, axis=-2)[..., None, :, :]

    area_abc = _cross(a, b, c)
    area_abd = _cross(a, b, d)
    area_cda = _cross(c, d, a)
    area_cdb = area_cda + area_abc - area_abd

    valid = (area_abc * area_abd < 0) & (area_cda * area_cdb < 0)
    denom = area_abd - area_abc
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(denom != 0, area_cda / np.where(denom == 0, 1.0, denom), 0.0)
    pts = a + t[..., None] * (b - a)
    shp = pts.shape[:-3] + (16, 2)
    return pts.reshape(shp), valid.reshape(shp[:-1])


def _convex_area_from_points(pts, valid):
    """Area of the convex point set (pts [..., M, 2], valid mask [..., M]).

    Sort valid points by angle around their centroid and fan-triangulate from
    the first valid point (ref:rotate_iou.py:23-30,33-73).
    """
    cnt = valid.sum(-1)
    w = valid.astype(np.float64)
    centroid = (pts * w[..., None]).sum(-2) / np.maximum(cnt, 1)[..., None]
    ang = np.arctan2(pts[..., 1] - centroid[..., None, 1],
                     pts[..., 0] - centroid[..., None, 0])
    ang = np.where(valid, ang, np.inf)            # invalid -> end
    order = np.argsort(ang, axis=-1)
    sp = np.take_along_axis(pts, order[..., None], axis=-2)

    # fan triangles rooted at sp[0]: sum |cross(p0, p_i, p_{i+1})| / 2
    p0 = sp[..., 0:1, :]
    pi = sp[..., 1:-1, :]
    pj = sp[..., 2:, :]
    tri = np.abs(_cross(p0, pi, pj)) / 2.0
    idx = np.arange(tri.shape[-1])
    tri_valid = idx[None] < np.maximum(cnt[..., None] - 2, 0)
    while tri_valid.ndim < tri.ndim:
        tri_valid = tri_valid[None]
    return (tri * tri_valid).sum(-1)


def rotated_intersection_area(rb1, rb2):
    """Pairwise intersection areas of rotated rects: [N,5] x [K,5] -> [N,K]."""
    c1 = rbbox_corners(rb1)[:, None]              # [N,1,4,2]
    c2 = rbbox_corners(rb2)[None, :]              # [1,K,4,2]
    N, K = rb1.shape[0], rb2.shape[0]
    c1 = np.broadcast_to(c1, (N, K, 4, 2))
    c2 = np.broadcast_to(c2, (N, K, 4, 2))

    in12 = _points_in_quad(c1, c2)                # [N,K,4]
    in21 = _points_in_quad(c2, c1)
    xpts, xval = _edge_intersections(c1, c2)      # [N,K,16,*]

    pts = np.concatenate([c1, c2, xpts], axis=-2)          # [N,K,24,2]
    valid = np.concatenate([in12, in21, xval], axis=-1)    # [N,K,24]
    return _convex_area_from_points(pts, valid)


def rotate_iou(boxes, qboxes, criterion=-1):
    """Pairwise rotated IoU (ref:rotate_iou.py:294 rotate_iou_gpu_eval)."""
    boxes = np.asarray(boxes, dtype=np.float64)
    qboxes = np.asarray(qboxes, dtype=np.float64)
    if boxes.shape[0] == 0 or qboxes.shape[0] == 0:
        return np.zeros([boxes.shape[0], qboxes.shape[0]])
    inter = rotated_intersection_area(boxes, qboxes)
    area1 = (boxes[:, 2] * boxes[:, 3])[:, None]
    area2 = (qboxes[:, 2] * qboxes[:, 3])[None, :]
    if criterion == -1:
        return inter / (area1 + area2 - inter)
    if criterion == 0:
        return inter / area1
    if criterion == 1:
        return inter / area2
    return inter


def d3_box_overlap(boxes, qboxes, criterion=-1):
    """3D IoU in camera coords: rotated BEV intersection x height overlap
    (ref:lib/eval/eval.py:119-160). boxes [N,7] = [x,y,z,l,h,w,ry]."""
    boxes = np.asarray(boxes, dtype=np.float64)
    qboxes = np.asarray(qboxes, dtype=np.float64)
    if boxes.shape[0] == 0 or qboxes.shape[0] == 0:
        return np.zeros([boxes.shape[0], qboxes.shape[0]])
    rinc = rotate_iou(boxes[:, [0, 2, 3, 5, 6]], qboxes[:, [0, 2, 3, 5, 6]],
                      criterion=2)                # raw intersection area
    # vertical overlap: y is the bottom face, boxes extend upward by h
    ymax = np.minimum(boxes[:, 1][:, None], qboxes[:, 1][None, :])
    ymin = np.maximum((boxes[:, 1] - boxes[:, 4])[:, None],
                      (qboxes[:, 1] - qboxes[:, 4])[None, :])
    ih = np.clip(ymax - ymin, 0, None)
    inter = ih * rinc
    vol1 = (boxes[:, 3] * boxes[:, 4] * boxes[:, 5])[:, None]
    vol2 = (qboxes[:, 3] * qboxes[:, 4] * qboxes[:, 5])[None, :]
    if criterion == -1:
        ua = vol1 + vol2 - inter
    elif criterion == 0:
        ua = vol1
    elif criterion == 1:
        ua = vol2
    else:
        ua = np.ones_like(inter)
    out = np.where((rinc > 0) & (ih > 0), inter / ua, 0.0)
    return out

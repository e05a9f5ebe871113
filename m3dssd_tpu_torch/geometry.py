"""Host-side (numpy, float64) geometry: 3D box corners and their
projection, the back-projected ray, alpha <-> rotY, the xywh -> xyxy box
convention, box overlaps, the regression transforms and the ignore rules
of the ground truths.

The port's own copy of what `inference/hill_climb.py`,
`inference/test_driver.py`, the KITTI label reader, the train targets
(`targets.py`), the anchors and the augmentations need.
"""

from __future__ import annotations

import numpy as np

# Unit-cube corner pattern shared by all 3D-box routines:
#   0 upper back right, 1 upper front right, 2 bottom front right,
#   3 bottom front left, 4 upper front left, 5 upper back left,
#   6 bottom back left,  7 bottom back right
_CORNER_X = np.array([0., 1., 1., 1., 1., 0., 0., 0.])  # scaled by l3d
_CORNER_Y = np.array([0., 0., 1., 1., 0., 0., 1., 1.])  # scaled by h3d
_CORNER_Z = np.array([0., 0., 0., 1., 1., 1., 1., 0.])  # scaled by w3d


def corners_3d(x3d, y3d, z3d, w3d, h3d, l3d, ry3d):
    """3D box corners in camera coordinates, shape [..., 3, 8].

    Accepts scalars or arrays broadcast against each other.
    """
    x3d, y3d, z3d, w3d, h3d, l3d, ry3d = np.broadcast_arrays(
        *[np.asarray(a, dtype=np.float64) for a in (x3d, y3d, z3d, w3d, h3d, l3d, ry3d)])
    shp = x3d.shape

    xc = _CORNER_X * l3d[..., None] - l3d[..., None] / 2.0
    yc = _CORNER_Y * h3d[..., None] - h3d[..., None] / 2.0
    zc = _CORNER_Z * w3d[..., None] - w3d[..., None] / 2.0

    c, s = np.cos(ry3d), np.sin(ry3d)
    # yaw rotation about the camera Y axis
    rx = c[..., None] * xc + s[..., None] * zc
    ry_ = yc
    rz = -s[..., None] * xc + c[..., None] * zc

    out = np.stack([rx + x3d[..., None], ry_ + y3d[..., None], rz + z3d[..., None]],
                   axis=len(shp))  # [..., 3, 8]
    return out


def project_3d(p2, x3d, y3d, z3d, w3d, h3d, l3d, ry3d, return_3d=False):
    """Project a 3D box into image-plane vertices, shape [..., 8, 2]: the 8
    corners, whose min/max is the tight 2D box."""
    c3d = corners_3d(x3d, y3d, z3d, w3d, h3d, l3d, ry3d)   # [..., 3, 8]
    ones = np.ones(c3d.shape[:-2] + (1, 8))
    hom = np.concatenate([c3d, ones], axis=-2)             # [..., 4, 8]
    proj = np.einsum("ij,...jk->...ik", np.asarray(p2), hom)
    uv = proj[..., :2, :] / proj[..., 2:3, :]
    verts = np.swapaxes(uv, -1, -2)                        # [..., 8, 2]
    if return_3d:
        return verts, c3d
    return verts


def bbox_from_verts(verts):
    """Tight [x1,y1,x2,y2] from projected vertices [..., 8, 2]."""
    mn = verts.min(axis=-2)
    mx = verts.max(axis=-2)
    return np.concatenate([mn, mx], axis=-1)


def backproject(p2_inv, x2d, y2d, z):
    """Back-project image point (x2d, y2d) at depth z to camera coords:
    p2_inv @ [x*z, y*z, z, 1]. Returns array [..., 4]."""
    x2d, y2d, z = np.broadcast_arrays(*[np.asarray(a, dtype=np.float64)
                                        for a in (x2d, y2d, z)])
    pts = np.stack([x2d * z, y2d * z, z, np.ones_like(z)], axis=-1)
    return pts @ np.asarray(p2_inv).T


def snap_to_pi(angle):
    """Wrap angle(s) to (-pi, pi]."""
    angle = np.asarray(angle, dtype=np.float64)
    return angle - np.round(angle / (2 * np.pi)) * 2 * np.pi


def convert_alpha_to_rot(alpha, z3d, x3d):
    """alpha -> rotY given camera-space position."""
    ry3d = np.asarray(alpha) + np.arctan2(-np.asarray(z3d), np.asarray(x3d)) + 0.5 * np.pi
    return snap_to_pi(ry3d)


def convert_rot_to_alpha(ry3d, z3d, x3d):
    """rotY -> alpha given camera-space position."""
    alpha = np.asarray(ry3d) - np.arctan2(-np.asarray(z3d), np.asarray(x3d)) - 0.5 * np.pi
    return snap_to_pi(alpha)


def xywh_to_xyxy(box):
    """[x,y,w,h] -> [x1,y1,x2,y2] with the -1 pixel convention.
    Non-destructive."""
    box = np.asarray(box, dtype=np.float64)
    if box.size == 0:
        return np.empty([0, 4])
    out = box.copy()
    out[..., 2] = box[..., 0] + box[..., 2] - 1
    out[..., 3] = box[..., 1] + box[..., 3] - 1
    return out


def intersect(box_a, box_b):
    """Pairwise intersection areas: box_a [M,4] x box_b [N,4] -> [M,N].

    No +1 in the width/height here.
    """
    box_a = np.asarray(box_a, dtype=np.float64)
    box_b = np.asarray(box_b, dtype=np.float64)
    max_xy = np.minimum(box_a[:, None, 2:4], box_b[None, :, 2:4])
    min_xy = np.maximum(box_a[:, None, 0:2], box_b[None, :, 0:2])
    wh = np.clip(max_xy - min_xy, 0, None)
    return wh[..., 0] * wh[..., 1]


def iou(box_a, box_b):
    """Pairwise IoU [M,N]."""
    inter = intersect(box_a, box_b)
    area_a = (box_a[:, 2] - box_a[:, 0]) * (box_a[:, 3] - box_a[:, 1])
    area_b = (box_b[:, 2] - box_b[:, 0]) * (box_b[:, 3] - box_b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / union


def iou_ign(box_a, box_b):
    """Fraction of each box_a covered by (ignore-region) box_b: [M,N].

    Union ignores box_b's area entirely.
    """
    inter = intersect(box_a, box_b)
    area_a = (box_a[:, 2] - box_a[:, 0]) * (box_a[:, 3] - box_a[:, 1])
    return inter / area_a[:, None]


# ----------------------------------------------------------------------------
# Regression transforms
# ----------------------------------------------------------------------------

def bbox_transform(ex_rois, gt_rois):
    """2D box -> regression target [dx, dy, dw, dh]."""
    ex_w = ex_rois[:, 2] - ex_rois[:, 0] + 1.0
    ex_h = ex_rois[:, 3] - ex_rois[:, 1] + 1.0
    ex_cx = ex_rois[:, 0] + 0.5 * (ex_w - 1)
    ex_cy = ex_rois[:, 1] + 0.5 * (ex_h - 1)

    gt_w = gt_rois[:, 2] - gt_rois[:, 0] + 1.0
    gt_h = gt_rois[:, 3] - gt_rois[:, 1] + 1.0
    gt_cx = gt_rois[:, 0] + 0.5 * (gt_w - 1.0)
    gt_cy = gt_rois[:, 1] + 0.5 * (gt_h - 1.0)

    return np.stack([(gt_cx - ex_cx) / ex_w,
                     (gt_cy - ex_cy) / ex_h,
                     np.log(gt_w / ex_w),
                     np.log(gt_h / ex_h)], axis=1)


def bbox_transform_3d(ex_rois_2d, ex_rois_3d, gt_rois):
    """3D regression targets.

    ex_rois_2d: [N,4] anchor 2D boxes; ex_rois_3d: [N,5] anchor (z,w,h,l,ry)
    stats; gt_rois: [N,11] = [cx2d, cy2d, z2d, w3d, h3d, l3d, alpha,
    cx3d, cy3d, cz3d, rotY] (projected-center encoding from the label parser).
    Returns [N, 7+extra]: [dx, dy, dz, sw, sh, sl, dry, <gt tail passthrough>].
    """
    ex_w = ex_rois_2d[:, 2] - ex_rois_2d[:, 0] + 1.0
    ex_h = ex_rois_2d[:, 3] - ex_rois_2d[:, 1] + 1.0
    ex_cx = ex_rois_2d[:, 0] + 0.5 * (ex_w - 1)
    ex_cy = ex_rois_2d[:, 1] + 0.5 * (ex_h - 1)

    dx = (gt_rois[:, 0] - ex_cx) / ex_w
    dy = (gt_rois[:, 1] - ex_cy) / ex_h
    dz = gt_rois[:, 2] - ex_rois_3d[:, 0]
    sw = np.log(gt_rois[:, 3] / ex_rois_3d[:, 1])
    sh = np.log(gt_rois[:, 4] / ex_rois_3d[:, 2])
    sl = np.log(gt_rois[:, 5] / ex_rois_3d[:, 3])
    dry = gt_rois[:, 6] - ex_rois_3d[:, 4]

    head = np.stack([dx, dy, dz, sw, sh, sl, dry], axis=1)
    return np.concatenate([head, gt_rois[:, 7:]], axis=1)


def determine_ignores(gts, lbls, ilbls, min_gt_vis=0.99, min_gt_h=0,
                      max_gt_h=10e10, scale_factor=1):
    """Ignore/remove flags per ground truth."""
    igns = np.zeros(len(gts), dtype=bool)
    rmvs = np.zeros(len(gts), dtype=bool)
    for i, gt in enumerate(gts):
        ign = bool(gt.ign)
        ign |= gt.visibility < min_gt_vis
        ign |= gt.bbox_full[3] * scale_factor < min_gt_h
        ign |= gt.bbox_full[3] * scale_factor > max_gt_h
        ign |= gt.cls in ilbls
        igns[i] = ign
        rmvs[i] = gt.cls not in (list(lbls) + list(ilbls))
    return igns, rmvs

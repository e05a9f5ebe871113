"""Host-side (numpy, float64) projective geometry for the eval path: 3D
box corners and their projection, the back-projected ray, alpha <-> rotY
and the xywh -> xyxy box convention.

The port's own copy of what `inference/hill_climb.py`,
`inference/test_driver.py` and the KITTI label reader need.
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

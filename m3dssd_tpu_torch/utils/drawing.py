"""Drawing of 2D, 3D and bird's-eye-view boxes, for debugging: the
reference package's `utils/drawing.py` (its re-derivation of the
upstream debug drawing). OpenCV is imported by each function, at use:
a machine without it imports this module all the same.
"""

from __future__ import annotations

import numpy as np

from .. import geometry as geo

# edges of the 3D box wireframe in the corner order of geometry.corners_3d
_BOX_EDGES = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6), (6, 7), (7, 0),
              (0, 5), (1, 4), (2, 7), (3, 6)]


def draw_2d_box(im, box_xywh, color=(0, 255, 0), thickness=2):
    """Draw an [x, y, w, h] box into `im` in place; returns it."""
    import cv2

    x, y, w, h = [int(round(v)) for v in box_xywh[:4]]
    cv2.rectangle(im, (x, y), (x + w, y + h), color, thickness)
    return im


def draw_3d_box(im, p2, x3d, y3d, z3d, w3d, h3d, l3d, ry3d,
                color=(0, 200, 200), thickness=1):
    """Project a 3D box with `p2` and draw its wireframe (nothing when a
    corner lies behind the camera); returns `im`."""
    import cv2

    verts, c3d = geo.project_3d(p2, x3d, y3d, z3d, w3d, h3d, l3d, ry3d,
                                return_3d=True)
    if np.any(c3d[2] <= 0):
        return im
    v = verts.astype(int)
    for a, b in _BOX_EDGES:
        cv2.line(im, tuple(v[a]), tuple(v[b]), color, thickness)
    return im


def draw_bev(canvas_size=(600, 600), boxes3d=None, z_range=60.0, x_range=30.0,
             colors=None):
    """Boxes in bird's-eye view on a uint8 canvas [H, W, 3], with range
    rings every 10 m. boxes3d rows: [x3d, z3d, w3d, l3d, ry3d]."""
    import cv2

    H, W = canvas_size
    canvas = np.full((H, W, 3), 30, np.uint8)

    def to_px(x, z):
        px = int((x + x_range) / (2 * x_range) * (W - 1))
        py = int((1 - z / z_range) * (H - 1))
        return px, py

    for r in range(10, int(z_range) + 1, 10):
        cv2.circle(canvas, to_px(0, 0), int(r / z_range * (H - 1)),
                   (60, 60, 60), 1)
    if boxes3d is not None:
        for i, (x, z, w, l, ry) in enumerate(np.asarray(boxes3d)):
            c, s = np.cos(ry), np.sin(ry)
            lx = np.array([-l, -l, l, l]) / 2
            lz = np.array([-w, w, w, -w]) / 2
            xs = c * lx + s * lz + x
            zs = -s * lx + c * lz + z
            pts = np.array([to_px(a, b) for a, b in zip(xs, zs)], np.int32)
            color = (0, 255, 0) if colors is None else colors[i]
            cv2.polylines(canvas, [pts], True, color, 1)
    return canvas

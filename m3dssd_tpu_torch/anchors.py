"""Anchor templates and their placement on the feature grid (host numpy).

Flattened roi order: row-major spatial, anchor fastest —
n = (h * W + w) * A + a. The model's head outputs are flattened in the same
(h, w, a) order (models/rpn.py:flatten_anchor_map), so rois, scores and box
regressions line up without a permutation.
"""

from __future__ import annotations

import numpy as np


def anchor_center(w, h, stride):
    """Center an anchor template of size (w, h) on the half-stride grid
    origin. Returns [x1, y1, x2, y2] (float64)."""
    return np.array([-w / 2 + (stride - 1) / 2,
                     -h / 2 + (stride - 1) / 2,
                     w / 2 + (stride - 1) / 2,
                     h / 2 + (stride - 1) / 2], dtype=np.float64)


def locate_anchors(anchors, feat_size, stride):
    """Spread anchor templates over the feature grid.

    Returns rois [H*W*A, 5] = [x1, y1, x2, y2, anchor_index] (float64) in
    (h, w, a) order.
    """
    anchors = np.asarray(anchors)
    H, W = int(feat_size[0]), int(feat_size[1])
    A = anchors.shape[0]

    sx = (np.arange(W) * float(stride))[None, :, None]     # [1,W,1]
    sy = (np.arange(H) * float(stride))[:, None, None]     # [H,1,1]
    t = anchors[:, :4].reshape(1, 1, A, 4)

    x1 = np.broadcast_to(sx + t[..., 0], (H, W, A))
    y1 = np.broadcast_to(sy + t[..., 1], (H, W, A))
    x2 = np.broadcast_to(sx + t[..., 2], (H, W, A))
    y2 = np.broadcast_to(sy + t[..., 3], (H, W, A))
    tracker = np.broadcast_to(np.arange(A, dtype=np.float64)[None, None, :],
                              (H, W, A))

    rois = np.stack([x1, y1, x2, y2, tracker], axis=-1).reshape(H * W * A, 5)
    return rois.astype(np.float64)

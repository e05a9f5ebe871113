"""Anchors of a configuration without a dataset, and their placement on
the feature grid, worked out from the configuration file's numbers.

The repository has no KITTI labels, so the anchors' 2D templates follow the
published ladder (num_anchor_scales heights, geometric between
percent_anc_h of the input height, times anchor_ratios widths) and their 3D
priors and the whitening statistics are synthesised: depth from the pinhole
height rule, a car-sized box, zero means and fixed deviations. Roi order is
(h, w, a), anchor fastest.
"""

from __future__ import annotations

import numpy as np


def anchor_center(w, h, stride):
    """[x1, y1, x2, y2] of a w x h template centred on the half-stride
    grid origin."""
    c = (stride - 1) / 2
    return np.array([-w / 2 + c, -h / 2 + c, w / 2 + c, h / 2 + c],
                    dtype=np.float64)


def synthetic_anchors(cfg: dict):
    """(anchors [A, 9] = x1, y1, x2, y2, z, w3, h3, l3, ry; bbox means
    [11]; bbox stds [11])."""
    height = cfg["test_scale"][0]
    lo, hi = (height * p for p in cfg["percent_anc_h"])
    n = int(cfg["num_anchor_scales"])
    scales = lo * (hi / lo) ** (np.arange(n) / (n - 1))
    stride = cfg["feat_stride"]
    a2d = np.stack([anchor_center(s * r, s, stride) for s in scales
                    for r in cfg["anchor_ratios"]])
    A = len(a2d)
    h = a2d[:, 3] - a2d[:, 1]
    priors = np.stack([720.0 * 1.5 / np.maximum(h, 1.0), np.full(A, 1.6),
                       np.full(A, 1.5), np.full(A, 3.9), np.zeros(A)], 1)
    means = np.zeros(11)
    stds = np.array([0.2] * 4 + [0.5] * 7)
    return np.concatenate([a2d, priors], 1), means, stds


def locate_anchors(anchors, cfg: dict):
    """rois [H*W*A, 5] = x1, y1, x2, y2, anchor index over the stride grid
    of the input size."""
    stride = cfg["feat_stride"]
    H, W = (int(np.ceil(s / stride)) for s in cfg["test_scale"])
    A = len(anchors)
    ys, xs, a = np.meshgrid(np.arange(H), np.arange(W), np.arange(A),
                            indexing="ij")
    t = np.asarray(anchors)[a, :4]
    shift = np.stack([xs, ys, xs, ys], -1) * float(stride)
    return np.concatenate([t + shift, a[..., None].astype(np.float64)],
                          -1).reshape(-1, 5)

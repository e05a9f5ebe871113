"""Anchor templates, their placement on the feature grid, the anchors' 3D
priors and the whitening statistics of the regression targets (host
numpy; the port's own copy of the reference package's `anchors.py`, less
its k-means clustering).

Flattened roi order: row-major spatial, anchor fastest —
n = (h * W + w) * A + a. The model's head outputs are flattened in the same
(h, w, a) order (models/rpn.py:flatten_anchor_map), so rois, scores and box
regressions line up without a permutation.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Optional

import numpy as np

from . import geometry as geo


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


def calc_output_size(res, stride):
    """ceil(res / stride)."""
    return np.ceil(np.asarray(res, dtype=np.float64) / stride).astype(int)


def _normalized_gts(conf, imdb):
    """Collect all valid gts, 2D-centered on the anchor grid, with 3D tails.

    Returns [G, 9]: [x1,y1,x2,y2 (centered), z3d, w3d, h3d, l3d, rotY].
   
    """
    rows = []
    for imobj in imdb:
        if len(imobj.gts) == 0:
            continue
        scale = imobj.scale * conf.test_scale[0] / imobj.imH
        igns, rmvs = geo.determine_ignores(imobj.gts, conf.lbls, conf.ilbls,
                                           conf.min_gt_vis, conf.min_gt_h,
                                           np.inf, scale)
        keep = (~rmvs) & (~igns)
        if not keep.any():
            continue
        gts_all = geo.xywh_to_xyxy(np.array([gt.bbox_full * scale for gt in imobj.gts]))
        gts_val = gts_all[keep]
        gts_3d = np.array([gt.bbox_3d for gt in imobj.gts])[keep]
        w = gts_val[:, 2] - gts_val[:, 0] + 1
        h = gts_val[:, 3] - gts_val[:, 1] + 1
        centered = np.stack([anchor_center(wi, hi, conf.feat_stride)
                             for wi, hi in zip(w, h)], axis=0)
        # bbox_3d columns of interest: [2]=depth, [3:6]=w3d,h3d,l3d, [6]=alpha.
        # NOTE: the rotation prior is the *observation angle* alpha, not rotY —
        # the reference accumulates normalized_gts col 10 == bbox_3d[6]
        # and converts back at test time via
        # convertAlpha2Rot.
        rows.append(np.concatenate(
            [centered, gts_3d[:, 2:3], gts_3d[:, 3:6], gts_3d[:, 6:7]], axis=1))
    if not rows:
        return np.zeros([0, 9])
    return np.concatenate(rows, axis=0)


def _assign_3d_priors(anchors2d, norm_gts, min_ol=0.2):
    """Attach mean (z,w3,h3,l3,ry) of best-matching gts to each anchor
   ."""
    A = anchors2d.shape[0]
    out = np.concatenate([anchors2d, np.zeros([A, 5])], axis=1)
    ols = geo.iou(anchors2d[:, :4], norm_gts[:, :4])      # [A, G]
    gt_anchor = np.argmax(ols, axis=0)
    gt_ols = np.max(ols, axis=0)
    valid = gt_ols > min_ol
    if not valid.any():
        raise ValueError("no ground truth matches any anchor")
    global_mean = norm_gts[valid, 4:9].mean(axis=0)
    unused = []
    for aind in range(A):
        sel = valid & (gt_anchor == aind)
        if sel.any():
            out[aind, 4:9] = norm_gts[sel, 4:9].mean(axis=0)
        else:
            # the reference errors out here; on
            # small datasets we instead back off to the global mean priors
            out[aind, 4:9] = global_mean
            unused.append(aind)
    if unused:
        logging.warning("%d/%d anchors matched no gt; using global 3D priors "
                        "for them: %s", len(unused), A, unused)
    return out


def generate_anchors(conf, imdb, cache_folder: Optional[str] = None):
    """Build the anchor set and write it onto conf."""
    cache = None if cache_folder is None else os.path.join(cache_folder, "anchors.pkl")
    if cache and os.path.exists(cache):
        with open(cache, "rb") as f:
            conf.anchors = pickle.load(f)
        return conf.anchors

    templates = []
    for scale in conf.anchor_scales:
        for ratio in conf.anchor_ratios:
            templates.append(anchor_center(scale * ratio, scale, conf.feat_stride))
    anchors = np.stack(templates, axis=0)

    if conf.cluster_anchors:
        raise NotImplementedError("k-means anchor clustering "
                                  "(conf.cluster_anchors) is not ported")
    if conf.has_3d:
        norm_gts = _normalized_gts(conf, imdb)
        anchors = _assign_3d_priors(anchors, norm_gts)

    anchors = anchors.astype(np.float64)
    if cache:
        os.makedirs(cache_folder, exist_ok=True)
        with open(cache, "wb") as f:
            pickle.dump(anchors, f)
    conf.anchors = anchors
    return anchors


def compute_bbox_stats(conf, imdb, cache_folder: Optional[str] = None):
    """Two-pass mean/std of all fg regression targets.

    Writes conf.bbox_means / conf.bbox_stds ([1,11] each, 2D then 3D params).
    Uses float128 accumulators like the reference when available.
    """
    from .targets import compute_targets, image_gt_arrays  # local import (cycle)

    means_p = None if cache_folder is None else os.path.join(cache_folder, "bbox_means.pkl")
    stds_p = None if cache_folder is None else os.path.join(cache_folder, "bbox_stds.pkl")
    if means_p and os.path.exists(means_p) and os.path.exists(stds_p):
        with open(means_p, "rb") as f:
            conf.bbox_means = pickle.load(f)
        with open(stds_p, "rb") as f:
            conf.bbox_stds = pickle.load(f)
        return conf.bbox_means, conf.bbox_stds

    acc_t = np.longdouble if hasattr(np, "longdouble") else np.float64
    dim = 11 if conf.has_3d else 4
    sums = np.zeros([1, dim], dtype=acc_t)
    sq = np.zeros([1, dim], dtype=acc_t)
    count = acc_t(1e-10)

    def _per_image_transforms(imobj):
        scale = imobj.scale * conf.test_scale[0] / imobj.imH
        feat_size = calc_output_size(np.array([imobj.imH, imobj.imW]) * scale,
                                     conf.feat_stride)
        rois = locate_anchors(conf.anchors, feat_size, conf.feat_stride)
        gts_val, gts_ign, gts_3d, box_lbls = image_gt_arrays(
            conf, imobj, scale_factor=scale, max_gt_h=np.inf)
        if gts_val.shape[0] == 0:
            return None
        tf, _, _ = compute_targets(
            gts_val, gts_ign, box_lbls, rois, conf.fg_thresh, conf.ign_thresh,
            conf.bg_thresh_lo, conf.bg_thresh_hi, conf.best_thresh,
            gts_3d=gts_3d if conf.has_3d else None,
            anchors=conf.anchors, tracker=rois[:, 4])
        fg = tf[:, 4] > 0
        if not fg.any():
            return None
        if conf.has_3d:
            return np.concatenate([tf[fg, 0:4], tf[fg, 5:12]], axis=1)
        return tf[fg, 0:4]

    per_image = []
    for imobj in imdb:
        if len(imobj.gts) == 0:
            per_image.append(None)
            continue
        t = _per_image_transforms(imobj)
        per_image.append(t)
        if t is not None:
            sums += t.sum(axis=0, dtype=acc_t)
            count += t.shape[0]

    means = sums / count
    for t in per_image:
        if t is not None:
            sq += np.power(t - means.astype(np.float64), 2).sum(axis=0, dtype=acc_t)
    stds = np.sqrt(sq / count)

    means = means.astype(np.float64)
    stds = stds.astype(np.float64)
    logging.info("bbox stats: used %d boxes, avg std %.4f", int(count), float(stds.mean()))

    if means_p:
        os.makedirs(cache_folder, exist_ok=True)
        with open(means_p, "wb") as f:
            pickle.dump(means, f)
        with open(stds_p, "wb") as f:
            pickle.dump(stds, f)
    conf.bbox_means, conf.bbox_stds = means, stds
    return means, stds

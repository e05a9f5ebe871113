"""Anchor templates, their placement on the feature grid, the anchors' 3D
priors and the whitening statistics of the regression targets (host
numpy; the port's own copy of the reference package's `anchors.py`,
k-means clustering included).

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

# k-means: the most rounds of one run at a fixed anchor count, and the least
# mean-IoU gain for which `expand_anchors` adds another anchor
KMEANS_MAX_ROUNDS = 1000
EXPAND_STOP_DT = 0.0025


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
        anchors = cluster_anchors(conf, anchors, imdb)
    elif conf.has_3d:
        norm_gts = _normalized_gts(conf, imdb)
        anchors = _assign_3d_priors(anchors, norm_gts)

    anchors = anchors.astype(np.float64)
    if cache:
        os.makedirs(cache_folder, exist_ok=True)
        with open(cache, "wb") as f:
            pickle.dump(anchors, f)
    conf.anchors = anchors
    return anchors


def _kmeans_rounds(anchors, norm_gts, stride, rng):
    """One IoU-metric k-means run at a fixed anchor count.

    Unused anchors are zeroed then re-seeded as load-weighted random convex
    combinations of the used anchors (the reference's redistribution step).
    Returns (best_valid_anchors, best_mean_iou, best_coverage@0.5).
    """
    A = anchors.shape[0]
    best_iou, best, best_cov = -1.0, anchors.copy(), 0.0
    last, dif, rnd = 0.0, 1.0, 0
    w_all = norm_gts[:, 2] - norm_gts[:, 0] + 1
    h_all = norm_gts[:, 3] - norm_gts[:, 1] + 1

    while rnd < KMEANS_MAX_ROUNDS and dif > 0.0:
        ols = geo.iou(anchors[:, :4], norm_gts[:, :4])      # [A, G]
        assign = np.argmax(ols, axis=0)
        gt_ols = np.max(ols, axis=0)
        cur = float(gt_ols.mean())

        counts = np.bincount(assign, minlength=A)
        for aind in range(A):
            sel = assign == aind
            if counts[aind] > 0:
                anchors[aind, :4] = anchor_center(
                    w_all[sel].mean(), h_all[sel].mean(), stride)
                anchors[aind, 4:9] = norm_gts[sel, 4:9].mean(axis=0)
            else:
                anchors[aind, :] = 0.0          # unused, reseed below

        anchors = np.nan_to_num(anchors)
        valid = ~np.all(anchors == 0, axis=1)
        vinds = np.flatnonzero(valid)

        if cur > best_iou:
            best_iou = cur
            best = anchors[valid].copy()
            best_cov = float(np.mean(gt_ols > 0.5))

        if not valid.all():
            # split load-heavy anchors: random convex combination weighted by
            # each used anchor's assignment share
            share = counts[vinds] / max(counts[vinds].sum(), 1)
            for aind in np.flatnonzero(~valid):
                multi = 0.5 * rng.random(len(vinds)) + share
                multi /= multi.sum()
                anchors[aind] = anchors[vinds].T @ multi
            logging.info("cluster_anchors: round %d reseeded %d unused "
                         "anchors", rnd, int((~valid).sum()))

        dif = cur - last
        last = cur
        rnd += 1
    return best, best_iou, best_cov


def _init_anchor_templates(conf, count, norm_gts):
    """Anchor (re)initialization at a given count for one expansion round.

    `even_anchors`: slice the height-sorted gts into `count` equal groups and
    seed each anchor with its group's mean w/h.
    Otherwise: geometric height ladder x aspect ratios, with the scale count
    chosen so scales x ratios == count (the reference's else-branch indexes
    out of bounds unless len(ratios) == 1)."""
    stride = conf.feat_stride
    templates = np.zeros([count, 9])
    if conf.even_anchors:
        order = np.argsort(norm_gts[:, 3] - norm_gts[:, 1] + 1)
        g = norm_gts[order]
        n = max(g.shape[0] // count, 1)
        for aind in range(count):
            grp = g[aind * n:aind * n + n]
            if grp.shape[0] == 0:
                grp = g[-n:]
            w = (grp[:, 2] - grp[:, 0] + 1).mean()
            h = (grp[:, 3] - grp[:, 1] + 1).mean()
            templates[aind, :4] = anchor_center(w, h, stride)
        return templates
    ratios = list(conf.anchor_ratios)
    n_scales = max(count // len(ratios), 1)
    base = (conf.max_gt_h / conf.min_gt_h) ** (1.0 / max(n_scales - 1, 1))
    aind = 0
    for i in range(n_scales):
        h = conf.min_gt_h * (base ** i)
        for r in ratios:
            if aind >= count:
                break
            templates[aind, :4] = anchor_center(h * r, h, stride)
            aind += 1
    # count not divisible by len(ratios): fill the tail with the largest scale
    while aind < count:
        templates[aind, :4] = anchor_center(
            conf.max_gt_h * ratios[aind % len(ratios)], conf.max_gt_h, stride)
        aind += 1
    return templates


def cluster_anchors(conf, anchors, imdb):
    """IoU-metric k-means over gt boxes with optional even-distribution
    seeding and anchor-count expansion.

    `conf.even_anchors`: seed anchors from equal height-sorted gt slices.
    `conf.expand_anchors` (> current count): after each converged run, add
    one anchor and re-run while the mean-IoU gain exceeds `EXPAND_STOP_DT`;
    the best configuration across all counts is returned. 3D prior tails are
    cluster means throughout.
    """
    norm_gts = _normalized_gts(conf, imdb)
    if norm_gts.shape[0] == 0:
        return anchors

    rng = np.random.default_rng(conf.rng_seed)
    A0 = anchors.shape[0]
    target = int(conf.expand_anchors) if conf.expand_anchors else A0

    best_iou, best, best_cov = -1.0, None, 0.0
    expand_last = 0.0
    count = A0
    cur9 = np.concatenate([anchors[:, :4], np.zeros([A0, 5])], axis=1)
    while True:
        if conf.even_anchors or count > A0:
            cur9 = _init_anchor_templates(conf, count, norm_gts)
        run_best, run_iou, run_cov = _kmeans_rounds(
            cur9.copy(), norm_gts, conf.feat_stride, rng)
        if run_iou > best_iou:
            best_iou, best, best_cov = run_iou, run_best, run_cov
        logging.info("cluster_anchors: count=%d mean_iou=%.4f coverage=%.4f",
                     count, run_iou, run_cov)
        expand_dif = best_iou - expand_last
        expand_last = best_iou
        if count < target and expand_dif > EXPAND_STOP_DT:
            count += 1
        else:
            break
    logging.info("cluster_anchors: final_iou=%.4f final_coverage=%.4f "
                 "anchors=%d", best_iou, best_cov, best.shape[0])
    return best


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

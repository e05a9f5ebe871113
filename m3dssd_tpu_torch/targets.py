"""Host-side anchor target assignment (numpy).

The port's own copy of the reference package's `targets.py`:
  * compute_targets — IoU-based fg/bg/ignore assignment and regression
                      transforms of every roi;
  * build_targets   — the per-image target dict of `pre_compute_target`
                      training.

  * build_gt_arrays — the padded per-image gts of the on-device
                      assignment (`pre_compute_target=False`,
                      ops/targets_device.py).

These run in the loader's threads; the loss takes only the fixed-shape
arrays they produce.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from . import geometry as geo
from .anchors import locate_anchors

IGN_FLAG = 3000  # sentinel class id of ignored anchors


def cls_name_to_ind(lbls, cls):
    """Class name -> 1-based index."""
    return list(lbls).index(cls) + 1


def image_gt_arrays(conf, imobj, scale_factor=1.0, max_gt_h=None):
    """Split an image's gts into (valid boxes, ignore boxes, 3d tails, labels).

    2D boxes are converted to xyxy and scaled; 3D projected centers are scaled
    when scale_factor != 1.
    """
    gts = imobj.gts
    if len(gts) == 0:
        z = np.zeros
        return z([0, 4]), z([0, 4]), z([0, 11]), z([0], dtype=int)
    mx = conf.max_gt_h if max_gt_h is None else max_gt_h
    igns, rmvs = geo.determine_ignores(gts, conf.lbls, conf.ilbls,
                                       conf.min_gt_vis, conf.min_gt_h, mx,
                                       scale_factor)
    gts_all = geo.xywh_to_xyxy(np.array([gt.bbox_full * scale_factor for gt in gts]))
    val_m = (~rmvs) & (~igns)
    ign_m = (~rmvs) & igns
    gts_val = gts_all[val_m]
    gts_ign = gts_all[ign_m]
    gts_3d = np.array([gt.bbox_3d for gt in gts], dtype=np.float64)
    gts_3d = gts_3d[val_m] if gts_3d.size else np.zeros([0, 11])
    if scale_factor != 1.0 and gts_3d.shape[0]:
        gts_3d = gts_3d.copy()
        gts_3d[:, 0:2] *= scale_factor
    box_lbls = np.array([cls_name_to_ind(conf.lbls, gt.cls)
                         for gt, v in zip(gts, val_m) if v], dtype=int)
    return gts_val, gts_ign, gts_3d, box_lbls


def build_gt_arrays(conf, imobj, g_max: Optional[int] = None
                    ) -> Dict[str, np.ndarray]:
    """Padded per-image gt arrays for the on-device target path.

    With `pre_compute_target=False` the batch carries only these (about
    1 KB per image) and the train step assigns the targets on the card
    (`ops/targets_device.py`), instead of the host's `build_targets` per
    image and the upload of its dense [N] targets.

    Returns gt_boxes2d [G,4] f32 (xyxy), gt_boxes3d [G,11] f32, gt_cls [G]
    i32 (1-based), gt_valid [G] i8, ign_boxes [G,4] f32, ign_valid [G] i8,
    truncated to `g_max` (conf.max_gts) valid/ignore boxes each.
    """
    G = int(conf.max_gts if g_max is None else g_max)
    gts_val, gts_ign, gts_3d, box_lbls = image_gt_arrays(conf, imobj)
    out = {
        "gt_boxes2d": np.zeros([G, 4], np.float32),
        "gt_boxes3d": np.zeros([G, 11], np.float32),
        "gt_cls": np.zeros([G], np.int32),
        "gt_valid": np.zeros([G], np.int8),
        "ign_boxes": np.zeros([G, 4], np.float32),
        "ign_valid": np.zeros([G], np.int8),
    }
    nv = min(gts_val.shape[0], G)
    if nv:
        out["gt_boxes2d"][:nv] = gts_val[:nv]
        out["gt_boxes3d"][:nv] = gts_3d[:nv]
        out["gt_cls"][:nv] = box_lbls[:nv]
        out["gt_valid"][:nv] = 1
    ni = min(gts_ign.shape[0], G)
    if ni:
        out["ign_boxes"][:ni] = gts_ign[:ni]
        out["ign_valid"][:ni] = 1
    return out


def compute_targets(gts_val, gts_ign, box_lbls, rois, fg_thresh, ign_thresh,
                    bg_thresh_lo, bg_thresh_hi, best_thresh,
                    gts_3d: Optional[np.ndarray] = None, anchors=None, tracker=None):
    """Assign every roi a label + regression transform.

    Returns (transforms, ols, raw_gt):
      transforms [N, 5 (+11)]: [dx,dy,dw,dh, label, dx3d,dy3d,dz,sw,sh,sl,dry,
      <4 raw-gt passthrough cols>] with label -1=bg, 0=ignore, >=1=fg class.
      (fully vectorized)
    """
    N = rois.shape[0]
    has_3d = gts_3d is not None
    width = 5 + (gts_3d.shape[1] if has_3d else 0)
    transforms = np.zeros([N, width], dtype=np.float32)
    raw_gt = np.zeros([N, width], dtype=np.float32)

    if gts_val.shape[0] == 0 and gts_ign.shape[0] == 0:
        transforms[:, 4] = -1
        return transforms, None, raw_gt

    if gts_ign.shape[0] > 0:
        ols_ign_max = geo.iou_ign(rois[:, :4], gts_ign).max(axis=1)
    else:
        ols_ign_max = np.zeros(N)

    ols = None
    fg_mask = np.zeros(N, dtype=bool)
    if gts_val.shape[0] > 0:
        ols = geo.iou(rois[:, :4], gts_val)                  # [N, G]
        ols_max = ols.max(axis=1)
        targets = np.argmax(ols, axis=1)

        # force the best roi per gt to be fg
        gt_best_rois = np.argmax(ols, axis=0)
        gt_best_ols = ols.max(axis=0)
        gt_best_rois = gt_best_rois[gt_best_ols >= best_thresh]

        fg_mask = ols_max >= fg_thresh
        fg_mask[gt_best_rois] = True
        fg_inds = np.flatnonzero(fg_mask)

        if fg_inds.size:
            src_rois = rois[fg_inds, :4]
            tgt_rois = gts_val[targets[fg_inds]]
            transforms[fg_inds, 0:4] = geo.bbox_transform(src_rois, tgt_rois)
            raw_gt[fg_inds, 0:4] = tgt_rois
            if has_3d:
                trk = np.asarray(tracker, dtype=np.int64)
                src_3d = np.asarray(anchors)[trk[fg_inds], 4:]
                tgt_3d = gts_3d[targets[fg_inds]]
                raw_gt[fg_inds, 5:] = tgt_3d
                transforms[fg_inds, 5:] = geo.bbox_transform_3d(src_rois, src_3d, tgt_3d)
            transforms[fg_inds, 4] = box_lbls[targets[fg_inds]]
    else:
        ols_max = np.zeros(N)
        gt_best_rois = np.zeros(0, dtype=int)

    ign_mask = ols_ign_max >= ign_thresh
    bg_mask = (ols_max >= bg_thresh_lo) & (ols_max < bg_thresh_hi)
    bg_mask &= ~ign_mask
    bg_mask &= ~fg_mask
    transforms[bg_mask, 4] = -1
    # anything not fg / bg stays label 0 = ignore

    return transforms, ols, raw_gt


def build_targets(conf, imobj, rois: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """Per-image training target dict.

    Keys: labels_fg/labels_bg/labels_ign [N] int8, labels [N] int32
    (IGN_FLAG for ignored), bbox_2d [N,4] f32 (whitened), bbox_3d [N,7] f32
    (whitened), any_val scalar int32.
    """
    feat_size = conf.feat_size
    if rois is None:
        rois = locate_anchors(conf.anchors, feat_size, conf.feat_stride)
    N = rois.shape[0]

    labels = np.zeros(N, dtype=np.int32)
    bbox_2d = np.zeros([N, 4], dtype=np.float32)
    bbox_3d = np.zeros([N, 7], dtype=np.float32)

    gts_val, gts_ign, gts_3d, box_lbls = image_gt_arrays(conf, imobj)

    if gts_val.shape[0] > 0:
        tf, _, _ = compute_targets(
            gts_val, gts_ign, box_lbls, rois, conf.fg_thresh, conf.ign_thresh,
            conf.bg_thresh_lo, conf.bg_thresh_hi, conf.best_thresh,
            gts_3d=gts_3d, anchors=conf.anchors, tracker=rois[:, 4])

        # whiten regression targets
        tf[:, 0:4] = (tf[:, 0:4] - conf.bbox_means[:, 0:4]) / conf.bbox_stds[:, 0:4]
        tf[:, 5:12] = (tf[:, 5:12] - conf.bbox_means[:, 4:]) / conf.bbox_stds[:, 4:]

        labels_fg = (tf[:, 4] > 0).astype(np.int8)
        labels_bg = (tf[:, 4] < 0).astype(np.int8)
        labels_ign = (tf[:, 4] == 0).astype(np.int8)
        labels[labels_fg.astype(bool)] = tf[labels_fg.astype(bool), 4].astype(np.int32)
        labels[labels_ign.astype(bool)] = IGN_FLAG
        bbox_2d[:] = tf[:, 0:4]
        bbox_3d[:] = tf[:, 5:12]
        any_val = np.int32(1)
    else:
        labels_fg = np.zeros(N, dtype=np.int8)
        labels_bg = np.ones(N, dtype=np.int8)
        labels_ign = np.zeros(N, dtype=np.int8)
        # any ground truths at all (even all-ignored) count, as the reference's
        # `any_val = ((rmvs==False)&(igns==False)).any()`
        igns, rmvs = (np.zeros(0, bool), np.zeros(0, bool)) if len(imobj.gts) == 0 \
            else geo.determine_ignores(imobj.gts, conf.lbls, conf.ilbls,
                                       conf.min_gt_vis, conf.min_gt_h,
                                       conf.max_gt_h, 1.0)
        any_val = np.int32(((~rmvs) & (~igns)).any()) if len(imobj.gts) else np.int32(0)

    return {
        "labels_fg": labels_fg,
        "labels_bg": labels_bg,
        "labels_ign": labels_ign,
        "labels": labels,
        "bbox_2d": bbox_2d,
        "bbox_3d": bbox_3d,
        "any_val": any_val,
    }

"""Anchor target assignment on the device, batched over images.

The port's counterpart of the reference package's `ops/targets_device.py`
(the `pre_compute_target=False` train path): the batch carries each image's
ground truths padded to G boxes (`targets.build_gt_arrays`), and the IoU
matrix, the assignment and the whitened regression targets are computed
here as fixed-shape torch ops, so only the gts travel to the card.

Inputs, per image b (padded to G):
    gt_boxes2d [B,G,4] xyxy; gt_boxes3d [B,G,11] (bbox_3d layout);
    gt_cls [B,G] int (1-based); gt_valid [B,G]; ign_boxes [B,G,4];
    ign_valid [B,G].
Without the leading B, one image.

The result has the keys and layouts of the host targets the loss reads
(`targets.build_targets` through `data.loader.collate`): labels [B,N]
int32 (IGN_FLAG for ignored), labels_fg/bg/ign [B,N] int8, channel-major
bbox_2d [B,4,N] and bbox_3d [B,7,N] float32, any_val [B] int32.

Semantics are the reference device path's: invalid and padded gts sit at
IoU -1, every valid gt whose best roi reaches best_thresh forces that roi
to fg (the forcing of several gts onto one roi ORs together), argmax ties
go to the first index, and an image without valid gts is all bg unless it
has ignore boxes (then its rois are bg only where they are not ignored,
which with IoU -1 is nowhere: the reference's device path labels them
ignored).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

IGN_FLAG = 3000
_GT_KEYS = ("gt_boxes2d", "gt_boxes3d", "gt_cls", "gt_valid", "ign_boxes",
            "ign_valid")


def _overlap(rois, boxes):
    """Intersection areas [B,N,G] and roi areas [N] of rois [N,4] with
    boxes [B,G,4], in the reference's order of operations."""
    r = rois[None, :, None, :]
    g = boxes[:, None, :, :]
    w = torch.clamp(torch.minimum(r[..., 2], g[..., 2])
                    - torch.maximum(r[..., 0], g[..., 0]), min=0)
    h = torch.clamp(torch.minimum(r[..., 3], g[..., 3])
                    - torch.maximum(r[..., 1], g[..., 1]), min=0)
    area_r = (rois[:, 2] - rois[:, 0]) * (rois[:, 3] - rois[:, 1])
    return w * h, area_r


def _iou_matrix(rois, gts, gt_valid):
    """IoU [B,N,G] of rois [N,4] with gts [B,G,4]; -1 at invalid gts."""
    inter, area_r = _overlap(rois, gts)
    area_g = (gts[..., 2] - gts[..., 0]) * (gts[..., 3] - gts[..., 1])
    iou = inter / torch.clamp(area_r[None, :, None] + area_g[:, None, :]
                              - inter, min=1e-9)
    return torch.where(gt_valid[:, None, :], iou, -1.0)


def _iou_ign(rois, igns, ign_valid):
    """Share of each roi covered by each ignore box [B,N,G]; -1 at invalid
    boxes."""
    inter, area_r = _overlap(rois, igns)
    cov = inter / torch.clamp(area_r, min=1e-9)[None, :, None]
    return torch.where(ign_valid[:, None, :], cov, -1.0)


def _encode(rois, anchors3d, gt2d, gt3d):
    """Regression targets of rois [N,4] with 3D priors anchors3d [N,5]
    against their assigned gts gt2d [B,N,4], gt3d [B,N,11] -> (t2d
    [B,N,4], t3d [B,N,7]); the math of geometry.bbox_transform(_3d)."""
    ew = rois[:, 2] - rois[:, 0] + 1.0
    eh = rois[:, 3] - rois[:, 1] + 1.0
    ecx = rois[:, 0] + 0.5 * (ew - 1)
    ecy = rois[:, 1] + 0.5 * (eh - 1)

    gw = gt2d[..., 2] - gt2d[..., 0] + 1.0
    gh = gt2d[..., 3] - gt2d[..., 1] + 1.0
    gcx = gt2d[..., 0] + 0.5 * (gw - 1.0)
    gcy = gt2d[..., 1] + 0.5 * (gh - 1.0)

    def log_ratio(a, b):
        return torch.log(torch.clamp(a / b, min=1e-9))

    t2d = torch.stack([(gcx - ecx) / ew, (gcy - ecy) / eh,
                       log_ratio(gw, ew), log_ratio(gh, eh)], dim=-1)
    t3d = torch.stack([
        (gt3d[..., 0] - ecx) / ew,
        (gt3d[..., 1] - ecy) / eh,
        gt3d[..., 2] - anchors3d[:, 0],
        log_ratio(gt3d[..., 3], anchors3d[:, 1]),
        log_ratio(gt3d[..., 4], anchors3d[:, 2]),
        log_ratio(gt3d[..., 5], anchors3d[:, 3]),
        gt3d[..., 6] - anchors3d[:, 4]], dim=-1)
    return t2d, t3d


def compute_targets_device(rois, anchors, bbox_means, bbox_stds,
                           gt_boxes2d, gt_boxes3d, gt_cls, gt_valid,
                           ign_boxes, ign_valid, fg_thresh=0.5,
                           ign_thresh=0.5, bg_thresh_lo=0.0,
                           bg_thresh_hi=0.5, best_thresh=0.35
                           ) -> Dict[str, torch.Tensor]:
    """Targets of every roi of each image, on the gts' device.

    rois [N,>=5] (column 4 the anchor index), anchors [A,9], bbox_means /
    bbox_stds [1,11] (tensors, or arrays moved to the gts' device); the gts
    as in the module docstring, with or without the batch dimension.
    """
    single = gt_boxes2d.dim() == 2
    if single:
        gt_boxes2d, gt_boxes3d, gt_cls, gt_valid, ign_boxes, ign_valid = (
            t[None] for t in (gt_boxes2d, gt_boxes3d, gt_cls, gt_valid,
                              ign_boxes, ign_valid))
    dev = gt_boxes2d.device
    f32 = torch.float32
    rois = torch.as_tensor(rois, dtype=f32, device=dev)
    anchors = torch.as_tensor(anchors, dtype=f32, device=dev)
    means = torch.as_tensor(bbox_means, dtype=f32, device=dev).reshape(-1)
    stds = torch.as_tensor(bbox_stds, dtype=f32, device=dev).reshape(-1)
    gt_boxes2d = gt_boxes2d.to(f32)
    gt_boxes3d = gt_boxes3d.to(f32)
    ign_boxes = ign_boxes.to(f32)
    gt_valid = gt_valid.bool()            # the loader ships int8
    ign_valid = ign_valid.bool()
    B, G = gt_valid.shape
    N = rois.shape[0]
    anchors3d = anchors[rois[:, 4].to(torch.int64)][:, 4:9]
    boxes = rois[:, :4]

    iou = _iou_matrix(boxes, gt_boxes2d, gt_valid)            # [B,N,G]
    ols_max, assign = torch.max(iou, dim=2)

    # best roi per gt forced to fg; several gts forcing one roi OR together
    gt_best_ols, gt_best_roi = torch.max(iou, dim=1)          # [B,G]
    force = gt_valid & (gt_best_ols >= best_thresh)
    forced = torch.zeros((B, N), dtype=torch.int8, device=dev).scatter_reduce(
        1, gt_best_roi, force.to(torch.int8), reduce="amax")
    has_gt = gt_valid.any(dim=1, keepdim=True)                # [B,1]
    fg = ((ols_max >= fg_thresh) | forced.bool()) & has_gt

    cov_ign = torch.max(_iou_ign(boxes, ign_boxes, ign_valid), dim=2).values
    ign = (cov_ign >= ign_thresh) & ~fg
    bg = (ols_max >= bg_thresh_lo) & (ols_max < bg_thresh_hi) & ~ign & ~fg
    # no valid gts and no ignore boxes: every roi is bg
    bg = torch.where(has_gt | ign_valid.any(dim=1, keepdim=True), bg, ~ign)
    ign_label = ~(fg | bg)

    g2 = torch.gather(gt_boxes2d, 1, assign[..., None].expand(B, N, 4))
    g3 = torch.gather(gt_boxes3d, 1, assign[..., None].expand(B, N, 11))
    t2d, t3d = _encode(boxes, anchors3d, g2, g3)
    t2d = (t2d - means[0:4]) / stds[0:4]
    t3d = (t3d - means[4:11]) / stds[4:11]
    fgf = fg[..., None]
    t2d = torch.where(fgf, t2d, 0.0)
    t3d = torch.where(fgf, t3d, 0.0)

    labels = torch.where(fg, torch.gather(gt_cls.to(torch.int32), 1, assign),
                         0)
    labels = torch.where(ign_label, IGN_FLAG, labels).to(torch.int32)
    out = {
        "labels": labels,
        "labels_fg": fg.to(torch.int8),
        "labels_bg": bg.to(torch.int8),
        "labels_ign": ign_label.to(torch.int8),
        "bbox_2d": t2d.transpose(1, 2).contiguous(),
        "bbox_3d": t3d.transpose(1, 2).contiguous(),
        "any_val": has_gt[:, 0].to(torch.int32),
    }
    if single:
        out = {k: v[0] for k, v in out.items()}
    return out


def make_device_target_fn(conf, rois):
    """`fn(batch) -> targets` for the train step: the assignment of
    `compute_targets_device` with conf's thresholds over the batch's padded
    gts (`targets.build_gt_arrays` keys). rois[:, :5], the anchors and the
    whitening stats are put on each device once."""
    kw = dict(fg_thresh=conf.fg_thresh, ign_thresh=conf.ign_thresh,
              bg_thresh_lo=conf.bg_thresh_lo, bg_thresh_hi=conf.bg_thresh_hi,
              best_thresh=conf.best_thresh)
    host = (np.asarray(rois)[:, :5], np.asarray(conf.anchors),
            np.asarray(conf.bbox_means), np.asarray(conf.bbox_stds))
    consts = {}

    def fn(batch):
        dev = batch["gt_valid"].device
        if dev not in consts:
            consts[dev] = tuple(torch.as_tensor(a, dtype=torch.float32,
                                                device=dev) for a in host)
        return compute_targets_device(*consts[dev],
                                      *(batch[k] for k in _GT_KEYS), **kw)

    return fn

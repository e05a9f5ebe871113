"""The M3DSSD detection loss on the model's channel-major outputs.

The port's copy of the reference package's `losses/rpn_loss.py`
(`rpn_3d_loss`), with its semantics:

  * per-image box sampling with budgets fg = round(N * box_samples *
    fg_fraction), bg = round(N * box_samples) - fg, taking the lowest-scoring
    candidates first (hard mining by the predicted probability of the
    labelled class), or random candidates with `hard_negatives` off;
  * batch-global fg/bg re-weighting fg_w = fg_fraction / (1 - fg_fraction)
    * bg_total / fg_total;
  * cross-entropy clipped per element to [0, 2000], mean over the sampled
    anchors;
  * SmoothL1 on the 7 whitened 3D parameters, mean over sampled fg;
  * -log IoU between the decoded predicted and target 2D boxes;
  * optional focal down-weighting (1 - p)^gamma and the 2D SmoothL1 branch;
  * optional, with the batch's `p2_inv`: SmoothL1 between the predicted and
    target boxes' camera-frame centers (`bbox_3d_proj_lambda`) and 1 - 3D
    GIoU between the boxes (`bbox_3d_iou_lambda`, `ops/iou3d.py`), both
    means over sampled fg, the target side outside autograd.

Everything is a fixed-shape tensor op: no host sync, so the stats stay on
the device until a caller reads them.

Under a data axis (`group`, `parallel/mesh.py`) each rank holds its rows of
the global batch. The batch-wide counts (fg_total, bg_total) and the
denominator of every mean are then the global batch's, summed over the
ranks by one all_reduce outside autograd, so each rank's loss is its
share of the global loss and the ranks' gradients sum to its gradient.
The stats are summed the same way: every rank reports the global ones.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..ops.boxes import (bbox_transform_inv_t, clip, convert_alpha_to_rot,
                         decode_bbox_3d_t, iou_list_t, masked_mean,
                         smooth_l1)
from ..ops.iou3d import giou_3d

IGN_FLAG = 3000


@dataclasses.dataclass(frozen=True)
class RPNLossConfig:
    box_samples: float = 0.20
    fg_fraction: float = 0.20
    hard_negatives: bool = True
    focal_loss: float = 0.0
    cls_2d_lambda: float = 1.0
    iou_2d_lambda: float = 1.0
    bbox_2d_lambda: float = 0.0
    bbox_3d_lambda: float = 1.0
    bbox_3d_proj_lambda: float = 0.0
    bbox_3d_iou_lambda: float = 0.0
    # leave out the logging-only stats (acc_fg/acc_bg, err_z/err_ry)
    light_stats: bool = False
    # read for the config's sake: the reference selects by bit bisection
    # under this flag, a TPU speed form with the same masks as its sort;
    # the port always selects with one stable sort
    mining_bisect: bool = False

    @staticmethod
    def from_conf(conf) -> "RPNLossConfig":
        return RPNLossConfig(
            box_samples=conf.box_samples, fg_fraction=conf.fg_fraction,
            hard_negatives=conf.hard_negatives, focal_loss=conf.focal_loss,
            cls_2d_lambda=conf.cls_2d_lambda, iou_2d_lambda=conf.iou_2d_lambda,
            bbox_2d_lambda=conf.bbox_2d_lambda,
            bbox_3d_lambda=conf.bbox_3d_lambda,
            bbox_3d_proj_lambda=conf.bbox_3d_proj_lambda,
            bbox_3d_iou_lambda=conf.bbox_3d_iou_lambda,
            light_stats=bool(conf.loss_light_stats),
            mining_bisect=bool(conf.loss_mining_bisect))


def rank_select_pools(score, pools, budgets):
    """For each pool, select its (up to) `budget` members of lowest score.

    One stable ascending sort of `score` serves every pool: restricted to a
    pool's members it keeps their order, so a member's rank in its pool is
    a cumsum of membership in the sorted order. The pool's threshold score
    s_t is that of its member at rank b_eff - 1 (b_eff = min(budget, pool
    size)); the kept set is every member below s_t plus the first
    (b_eff - #below) members equal to s_t in original order, which is what
    the stable sort selects.

    score [B,N]; pools: list of [B,N] bool; budgets: list of [B] int
    tensors. Returns a list of [B,N] bool masks.
    """
    flags = sum(p.to(torch.int32) << i for i, p in enumerate(pools))
    s_sorted, order = torch.sort(score, dim=1, stable=True)
    f_sorted = torch.gather(flags, 1, order)
    keeps = []
    for i, (pool, budget) in enumerate(zip(pools, budgets)):
        p_sorted = (f_sorted >> i) & 1
        rank = torch.cumsum(p_sorted, dim=1) - 1
        b_eff = torch.minimum(budget, rank[:, -1] + 1)           # [B]
        at_last = (p_sorted > 0) & (rank == b_eff[:, None] - 1)
        j = torch.argmax(at_last.to(torch.int32), dim=1)          # first True
        s_t = torch.gather(s_sorted, 1, j[:, None])
        below = pool & (score < s_t)
        ties = pool & (score == s_t)
        n_below = below.sum(dim=1, keepdim=True)
        tie_rank = torch.cumsum(ties.to(torch.int32), dim=1)
        keep = below | (ties & (tie_rank <= b_eff[:, None] - n_below))
        keeps.append(keep & (b_eff > 0)[:, None])
    return keeps


def take_class_t(v_t, lbl):
    """v_t[:, lbl] per anchor of a channel-major [B, C, N] tensor."""
    out = torch.zeros_like(v_t[:, 0])
    for c in range(v_t.shape[1]):
        out = torch.where(lbl == c, v_t[:, c], out)
    return out


def argmax_class_t(v_t):
    """argmax over the class dim of [B, C, N] (first maximum on ties)."""
    best = v_t[:, 0]
    pred = torch.zeros(best.shape, dtype=torch.int64, device=v_t.device)
    for c in range(1, v_t.shape[1]):
        take = v_t[:, c] > best
        pred = torch.where(take, c, pred)
        best = torch.maximum(best, v_t[:, c])
    return pred


def decode_3d_t(rois, anchors, means, stds, *deltas):
    """Each whitened 3D delta [B,7,N] decoded against rois [N,5] and the 3D
    priors of their anchors [A,9] -> [B,7,N] (x2d, y2d, z, w3d, h3d, l3d,
    alpha); means/stds [11]."""
    src3d_t = anchors[rois[:, 4].to(torch.int64)][:, 4:9].t()   # [5, N]
    return [decode_bbox_3d_t(rois.t(), d, src3d_t, means, stds)
            for d in deltas]


def cam_boxes_t(d, p2_inv):
    """Decoded boxes d [B,7,N] (x2d, y2d, z, w3d, h3d, l3d, alpha) ->
    camera-frame boxes [B,7,N] = [x, y (bottom), z, h, w, l, ry] through
    p2_inv [B,4,4]."""
    x2d, y2d, z = d[:, 0], d[:, 1], d[:, 2]
    pts = torch.stack([x2d * z, y2d * z, z, torch.ones_like(z)], dim=1)
    c3 = torch.einsum("bij,bjn->bin", p2_inv, pts)         # [B,4,N]
    ry = convert_alpha_to_rot(d[:, 6], c3[:, 2], c3[:, 0])
    return torch.stack([c3[:, 0], c3[:, 1] + d[:, 4] / 2, c3[:, 2],
                        d[:, 4], d[:, 3], d[:, 5], ry], dim=1)


def rpn_3d_loss(outputs: Dict[str, torch.Tensor],
                batch: Dict[str, torch.Tensor], rois: torch.Tensor,
                anchors: torch.Tensor, bbox_means: torch.Tensor,
                bbox_stds: torch.Tensor, cfg: RPNLossConfig,
                generator: Optional[torch.Generator] = None, group=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The total detection loss and a dict of detached stats.

    outputs: the model's dict (cls_t, prob_t [B,C,N]; lse [B,N]; bbox_2d
    [B,4,N]; bbox_3d [B,7,N]). batch: labels [B,N] (IGN_FLAG ignored),
    labels_fg/bg/ign [B,N], bbox_2d [B,4,N] and bbox_3d [B,7,N] whitened
    targets, any_val [B]. rois [N,5]; anchors [A,9]; bbox_means/stds [1,11].
    `generator` draws the random sampling scores when hard_negatives is off:
    under `group` it draws the global batch's scores (the same generator
    state on every rank) and takes this rank's rows, so the sampling does
    not depend on the split.
    """
    f32 = torch.float32
    cls_t = outputs["cls_t"].to(f32)                        # [B,C,N]
    prob_t = outputs["prob_t"].to(f32).detach()
    lse = outputs["lse"].to(f32)                            # [B,N]
    B, C, N = cls_t.shape
    dev = cls_t.device
    bbox_2d = outputs["bbox_2d"].to(f32)
    bbox_3d = outputs["bbox_3d"].to(f32)
    means = torch.as_tensor(bbox_means, dtype=f32, device=dev).reshape(-1)
    stds = torch.as_tensor(bbox_stds, dtype=f32, device=dev).reshape(-1)
    rois = torch.as_tensor(rois, dtype=f32, device=dev)
    anchors = torch.as_tensor(anchors, dtype=f32, device=dev)

    labels = batch["labels"].to(torch.int64)
    is_fg = batch["labels_fg"].bool()
    is_bg = batch["labels_bg"].bool()
    is_ign = batch["labels_ign"].bool()
    any_val = batch["any_val"].bool()                       # [B]

    # ---------------------------------------------------------- box sampling
    fg_budget = round(N * cfg.box_samples * cfg.fg_fraction)
    total_budget = round(N * cfg.box_samples)
    n_fg = is_fg.sum(dim=1)
    n_ign = is_ign.sum(dim=1)
    # an image takes part iff it has valid gts and fg or ignored anchors
    participates = any_val & ((n_fg > 0) | (n_ign > 0))
    fg_num = torch.clamp(n_fg, max=fg_budget)
    bg_num = total_budget - fg_num

    lbl_for_score = torch.where(labels == IGN_FLAG, 0, labels)
    score = take_class_t(prob_t, lbl_for_score)
    if cfg.hard_negatives:
        sel_score = score
    else:
        if generator is None:
            raise ValueError("random sampling (hard_negatives off) needs a "
                             "generator")
        W, r = (1, 0) if group is None else (dist.get_world_size(group),
                                             dist.get_rank(group))
        sel_score = torch.rand((W * B, N), generator=generator,
                               device=dev)[r * B:(r + 1) * B]
    sel_fg, sel_bg = rank_select_pools(sel_score, [is_fg, is_bg],
                                       [fg_num, bg_num])
    sel_fg = sel_fg & participates[:, None]
    sel_bg = sel_bg & participates[:, None]
    active = sel_fg | sel_bg
    lab_fg_all = (labels > 0) & (labels != IGN_FLAG)
    # the batch-wide counts: every denominator below is one of them
    counts = torch.stack([sel_fg.sum(), sel_bg.sum(), active.sum(),
                          lab_fg_all.sum(), (labels == 0).sum()])
    if group is not None:
        dist.all_reduce(counts, group=group)
    fg_total, bg_total = counts[0], counts[1]
    n_active, n_lab_fg, n_lab_bg = counts[2:].to(f32).unbind()
    n_fg_sel = fg_total.to(f32)

    fg_w = torch.where(
        fg_total > 0,
        (cfg.fg_fraction / (1 - cfg.fg_fraction))
        * (bg_total.to(f32) / torch.clamp(fg_total, min=1).to(f32)),
        torch.zeros((), dtype=f32, device=dev))
    labels_weight = sel_fg.to(f32) * fg_w + sel_bg.to(f32)
    if cfg.focal_loss:
        labels_weight = labels_weight * (1.0 - score) ** cfg.focal_loss

    stats: Dict[str, torch.Tensor] = {}
    loss = torch.zeros((), dtype=f32, device=dev)

    # ------------------------------------------------------------- cls loss
    if cfg.cls_2d_lambda:
        # -log_softmax[lbl] == lse - logit[lbl]
        ce = lse - take_class_t(cls_t, lbl_for_score)
        ce = clip(ce * labels_weight, 0.0, 2000.0)
        loss_cls = masked_mean(ce, active, n_active) * cfg.cls_2d_lambda
        loss = loss + loss_cls
        stats["loss_cls"] = loss_cls

    if not cfg.light_stats:
        cls_pred = argmax_class_t(cls_t)
        stats["acc_fg"] = masked_mean((cls_pred == labels).to(f32),
                                      lab_fg_all, n_lab_fg)
        stats["acc_bg"] = masked_mean((cls_pred == 0).to(f32), labels == 0,
                                      n_lab_bg)

    # --------------------------------------------------------- box losses
    bbox_weights = sel_fg.to(f32)
    for key, lam, pred, tkey in (
            ("loss_bbox3d", cfg.bbox_3d_lambda, bbox_3d, "bbox_3d"),
            ("loss_bbox2d", cfg.bbox_2d_lambda, bbox_2d, "bbox_2d")):
        if not lam:
            continue
        l1 = smooth_l1(pred, batch[tkey].to(f32))
        per_param = torch.stack([masked_mean(l1[:, p], bbox_weights,
                                             n_fg_sel)
                                 for p in range(l1.shape[1])])
        term = per_param.sum() * lam
        loss = loss + term
        stats[key] = term

    # ------------------------------------------------- decoded IoU loss/stats
    rois_t = rois.t()                                    # [5, N]
    coords = bbox_transform_inv_t(rois_t, bbox_2d, means[0:4], stds[0:4])
    coords_tar = bbox_transform_inv_t(rois_t, batch["bbox_2d"].to(f32),
                                      means[0:4], stds[0:4])
    ious = iou_list_t(coords, coords_tar)
    stats["iou"] = masked_mean(ious, bbox_weights, n_fg_sel)
    if cfg.iou_2d_lambda:
        iou_loss = -torch.log(clip(ious, 1e-7, 1.0))
        loss_iou = masked_mean(iou_loss, bbox_weights, n_fg_sel) \
            * cfg.iou_2d_lambda
        loss = loss + loss_iou
        stats["loss_iou"] = loss_iou

    # the decode also feeds the projection / 3D-IoU branches below
    need_decode = (not cfg.light_stats or cfg.bbox_3d_proj_lambda
                   or cfg.bbox_3d_iou_lambda)
    if need_decode:
        dec, dec_tar = decode_3d_t(rois, anchors, means, stds, bbox_3d,
                                   batch["bbox_3d"].to(f32))
    if not cfg.light_stats:
        stats["err_z"] = masked_mean(torch.abs(dec[:, 2] - dec_tar[:, 2]),
                                     bbox_weights, n_fg_sel)
        stats["err_ry"] = masked_mean(torch.abs(dec[:, 6] - dec_tar[:, 6]),
                                      bbox_weights, n_fg_sel)

    # ---------------------- 3D projection / rotated 3D GIoU loss branches
    if (cfg.bbox_3d_proj_lambda or cfg.bbox_3d_iou_lambda) \
            and "p2_inv" in batch:
        p2_inv = batch["p2_inv"].to(f32)                 # [B,4,4]
        cams = cam_boxes_t(dec, p2_inv)
        cams_tar = cam_boxes_t(dec_tar, p2_inv).detach()
        if cfg.bbox_3d_proj_lambda:
            proj_l1 = smooth_l1(cams[:, 0:3], cams_tar[:, 0:3]).sum(1)
            loss_proj = masked_mean(proj_l1, bbox_weights, n_fg_sel) \
                * cfg.bbox_3d_proj_lambda
            loss = loss + loss_proj
            stats["loss_bbox3d_proj"] = loss_proj
        if cfg.bbox_3d_iou_lambda:
            # every row, weighted afterwards, as the reference computes it
            g, _ = giou_3d(cams.transpose(1, 2).reshape(-1, 7),
                           cams_tar.transpose(1, 2).reshape(-1, 7))
            loss_giou = masked_mean((1.0 - g).reshape(B, N), bbox_weights,
                                    n_fg_sel) * cfg.bbox_3d_iou_lambda
            loss = loss + loss_giou
            stats["loss_bbox3d_iou"] = loss_giou

    stats["loss"] = loss
    stats = {k: v.detach() for k, v in stats.items()}
    if group is not None:
        keys = sorted(stats)
        shares = torch.stack([stats[k] for k in keys])
        dist.all_reduce(shares, group=group)
        stats = dict(zip(keys, shares.unbind()))
    stats["fg_count"] = n_fg_sel
    stats["bg_count"] = bg_total.to(f32)
    return loss, stats

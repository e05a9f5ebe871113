"""Box decode and greedy NMS of the detector's outputs into its table of
detections, in plain PyTorch.

Columns: x1 y1 x2 y2 score cls x3d y3d z3d w3d h3d l3d ry3d anchor-index.
Boxes are decoded against the rois with the whitening statistics, divided
by each image's scale factor; NMS is greedy over the anchors whose score is
at least score_thres (highest score first, the earlier anchor first among
equal scores; IoU with +1-pixel areas, suppression above nms_thres), and
keeps the first nms_topN_post. Unused rows have score -1 and the boxes of
anchor 0.

Suppression is a hard threshold on an IoU that two float32 decodes of the
same deltas can put a rounding step apart. When a table is judged, the
reference follows that table wherever an IoU lies within IOU_MARGIN of
nms_thres: such a candidate stays if the table kept it and is suppressed
if it did not. Every other decision is the reference's own.
"""

from __future__ import annotations

import torch

# 1 ulp of float32 in a coordinate of up to 2,048 px moves the IoU of two
# boxes of 5 px or more by at most about 2e-5
IOU_MARGIN = 1e-4
# relative closeness (as the table's comparison measures it) under which a
# row of the judged table is taken for a candidate with its score
ROW_MATCH = 1e-3


def decode(rois, anchors, means, stds, d2, d3, sf):
    """rois [N,5], anchors [A,9], means/stds [11] (float tensors); d2
    [4,N], d3 [7,N] whitened deltas of one image; sf its scale factor ->
    (boxes [N,4] x1 y1 x2 y2, box3d [N,7] x y z w h l ry)."""
    w = rois[:, 2] - rois[:, 0] + 1.0
    h = rois[:, 3] - rois[:, 1] + 1.0
    cx = rois[:, 0] + 0.5 * w
    cy = rois[:, 1] + 0.5 * h
    d = d2.T * stds[:4] + means[:4]
    pcx, pcy = d[:, 0] * w + cx, d[:, 1] * h + cy
    pw, ph = torch.exp(d[:, 2]) * w, torch.exp(d[:, 3]) * h
    boxes = torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw,
                         pcy + 0.5 * ph], 1) / sf
    prior = anchors[rois[:, 4].long(), 4:9]
    e = d3.T * stds[4:] + means[4:]
    box3d = torch.stack([(e[:, 0] * w + cx) / sf, (e[:, 1] * h + cy) / sf,
                         prior[:, 0] + e[:, 2],
                         torch.exp(e[:, 3]) * prior[:, 1],
                         torch.exp(e[:, 4]) * prior[:, 2],
                         torch.exp(e[:, 5]) * prior[:, 3],
                         prior[:, 4] + e[:, 6]], 1)
    return boxes, box3d


def greedy_nms(boxes, scores, thresh: float, floor: float, keep_max: int,
               judged_kept=None):
    """Indices kept by greedy NMS among the boxes scoring >= floor, best
    first, at most keep_max. With `judged_kept` [N] bool, an IoU within
    IOU_MARGIN of thresh suppresses exactly the candidates not in it."""
    cand = torch.nonzero(scores >= floor)[:, 0]
    # best score first; among equal scores the lower index
    order = cand[torch.argsort(-scores[cand], stable=True)]
    b = boxes[order]
    area = (b[:, 2] - b[:, 0] + 1.0) * (b[:, 3] - b[:, 1] + 1.0)
    alive = torch.ones(len(order), dtype=torch.bool, device=boxes.device)
    kept = []
    while len(kept) < keep_max:
        left = torch.nonzero(alive)
        if len(left) == 0:
            break
        i = int(left[0, 0])
        kept.append(int(order[i]))
        iw = (torch.minimum(b[i, 2], b[:, 2]) - torch.maximum(b[i, 0], b[:, 0])
              + 1.0).clamp(min=0.0)
        ih = (torch.minimum(b[i, 3], b[:, 3]) - torch.maximum(b[i, 1], b[:, 1])
              + 1.0).clamp(min=0.0)
        inter = iw * ih
        iou = inter / (area[i] + area - inter)
        keep = iou <= thresh
        if judged_kept is not None:
            band = (iou - thresh).abs() <= IOU_MARGIN
            keep = torch.where(band, judged_kept[order], keep)
        alive &= keep
        alive[i] = False
    return kept


def kept_by(table, boxes, scores):
    """[N] bool: the anchors that a valid row of `table` [K, 14] holds,
    by their exact score and a 2D box within ROW_MATCH."""
    rows = table[table[:, 4] >= 0]
    out = torch.zeros_like(scores, dtype=torch.bool)
    if len(rows) == 0:
        return out
    cand = torch.nonzero(scores >= rows[:, 4].min())[:, 0]
    b = boxes[cand, None]
    same = scores[cand, None] == rows[None, :, 4]
    near = ((b - rows[None, :, :4]).abs()
            / b.abs().clamp(min=1.0)).amax(-1) <= ROW_MATCH
    out[cand] = (same & near).any(-1)
    return out


def detections(cfg: dict, rois, anchors, means, stds, scores, cls_pred, d2,
               d3, sf, judged=None):
    """The table [nms_topN_post, 14] of one image from its outputs: scores,
    cls_pred [N]; d2 [4,N]; d3 [7,N]; sf its scale factor. `judged`, a
    table [nms_topN_post, 14] of the same outputs, is followed where an IoU
    lies within IOU_MARGIN of nms_thres."""
    boxes, box3d = decode(rois, anchors, means, stds, d2, d3, sf)
    keep = greedy_nms(boxes, scores, float(cfg["nms_thres"]),
                      float(cfg["score_thres"]), int(cfg["nms_topN_post"]),
                      None if judged is None
                      else kept_by(judged.float(), boxes, scores))
    K = int(cfg["nms_topN_post"])
    idx = torch.zeros(K, dtype=torch.long, device=scores.device)
    idx[:len(keep)] = torch.as_tensor(keep, dtype=torch.long,
                                      device=scores.device)
    score = torch.full((K,), -1.0, device=scores.device)
    score[:len(keep)] = scores[idx[:len(keep)]]
    return torch.cat([boxes[idx], score[:, None],
                      cls_pred[idx].float()[:, None], box3d[idx],
                      rois[idx, 4:5]], 1)

"""Greedy 2D NMS, batched over images: sequential first-k selection over
every candidate, a parallel bitmask fixpoint over a compacted candidate
set, and a plain numpy oracle.

IoU uses the +1 pixel area convention of the reference NMS kernels.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .compact import first_m_true


def nms_select_t(boxes_t, scores, iou_thresh: float, num_out: int,
                 stop_below: Optional[float] = None):
    """Greedy NMS returning only the first `num_out` survivors per image.

    boxes_t [B, 4, N] (or [4, N]) channel-major boxes; scores [B, N] (or
    [N]). Each round picks every image's highest-scoring active box and
    suppresses its overlaps (IoU > iou_thresh) and itself; the B images run
    their rounds together, each with its own argmax and stop flag. This is
    exactly full greedy NMS per image followed by keeping the first
    `num_out` kept boxes.

    stop_below: an image stops selecting once its best remaining score
    drops below it; its later slots come back valid=False with index 0.
    Without it every round records its argmax, valid while that score is
    above -inf.

    Returns (indices [B, num_out] int64, valid [B, num_out] bool), without
    the batch dimension when given [4, N] boxes.
    """
    single = boxes_t.dim() == 2
    if single:
        boxes_t, scores = boxes_t[None], scores[None]
    B, _, N = boxes_t.shape
    dev = boxes_t.device
    x1, y1, x2, y2 = boxes_t[:, 0], boxes_t[:, 1], boxes_t[:, 2], boxes_t[:, 3]
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    active = scores.to(torch.float32).clone()
    arange_n = torch.arange(N, device=dev)
    idxs = torch.zeros((B, num_out), dtype=torch.int64, device=dev)
    valid = torch.zeros((B, num_out), dtype=torch.bool, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)

    for k in range(num_out):
        i = torch.argmax(active, dim=1, keepdim=True)          # [B,1]
        cur = active.gather(1, i)                              # [B,1]
        if stop_below is None:
            ok = cur > float("-inf")
            idxs[:, k] = i[:, 0]
        else:
            ok = cur >= float(stop_below)
            if not bool(ok.any()):
                break
            idxs[:, k] = torch.where(ok[:, 0], i[:, 0], 0)
        valid[:, k] = ok[:, 0]
        xx1 = torch.maximum(x1.gather(1, i), x1)
        yy1 = torch.maximum(y1.gather(1, i), y1)
        xx2 = torch.minimum(x2.gather(1, i), x2)
        yy2 = torch.minimum(y2.gather(1, i), y2)
        inter = (torch.clamp(xx2 - xx1 + 1.0, min=0.0)
                 * torch.clamp(yy2 - yy1 + 1.0, min=0.0))
        iou = inter / (area.gather(1, i) + area - inter)
        suppress = (iou > iou_thresh) | (arange_n[None, :] == i)
        active = torch.where(ok & suppress, neg_inf, active)

    if single:
        return idxs[0], valid[0]
    return idxs, valid


def nms_bitmask_select_t(boxes_t, scores, iou_thresh: float, num_out: int):
    """Greedy NMS over a small candidate set by a parallel fixpoint.

    boxes_t [B, 4, C] (or [4, C]); scores [B, C] (or [C]). Each image sorts
    its candidates by score (stable, so of two equal scores the earlier
    index comes first, as argmax does in `nms_select_t`), builds the
    [C, C] overlap matrix over[j, i] = "j ranks before i and overlaps it"
    between candidates above -inf, and iterates
    keep <- active & ~(overᵀ keep) from keep = active. The fixpoint is the
    greedy keep vector and is reached in suppression-chain-depth rounds;
    the B images iterate together until none changes (a converged image
    stays where it is). Gives exactly the indices of `nms_select_t`
    without `stop_below` on the same candidates; the [B, C, C] matrix is
    its memory cost.

    Returns (indices [B, num_out] int64 into the original order, valid
    [B, num_out] bool), without the batch dimension for [4, C] boxes.
    """
    single = boxes_t.dim() == 2
    if single:
        boxes_t, scores = boxes_t[None], scores[None]
    B, _, C = boxes_t.shape
    dev = boxes_t.device
    order = torch.argsort(-scores.to(torch.float32), dim=1, stable=True)
    b = boxes_t.gather(2, order[:, None, :].expand(B, 4, C))
    active = scores.to(torch.float32).gather(1, order) > float("-inf")

    x1, y1, x2, y2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    xx1 = torch.maximum(x1[:, :, None], x1[:, None, :])
    yy1 = torch.maximum(y1[:, :, None], y1[:, None, :])
    xx2 = torch.minimum(x2[:, :, None], x2[:, None, :])
    yy2 = torch.minimum(y2[:, :, None], y2[:, None, :])
    inter = (torch.clamp(xx2 - xx1 + 1.0, min=0.0)
             * torch.clamp(yy2 - yy1 + 1.0, min=0.0))
    iou = inter / (area[:, :, None] + area[:, None, :] - inter)
    ar = torch.arange(C, device=dev)
    tri = ar[:, None] < ar[None, :]
    over = ((iou > iou_thresh) & tri & active[:, None, :]
            & active[:, :, None]).to(torch.float32)

    keep = active
    for _ in range(C):
        # suppressed[i] = any kept j with over[j, i]; 0/1 sums are exact
        suppressed = torch.bmm(keep.to(torch.float32)[:, None, :],
                               over)[:, 0] > 0.0
        new = active & ~suppressed
        if torch.equal(new, keep):
            break
        keep = new

    pos, _ = first_m_true(keep, num_out)             # sentinel C when unused
    valid = pos < C
    idxs = torch.where(valid, order.gather(1, pos.clamp(max=C - 1)), 0)
    if single:
        return idxs[0], valid[0]
    return idxs, valid


def py_cpu_nms(dets, thresh):
    """Plain greedy NMS in numpy: dets [N, 5] with the score in column 4.
    Returns the kept indices in descending score order."""
    x1, y1, x2, y2 = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3]
    scores = dets[:, 4]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]

    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][ovr <= thresh]
    return keep

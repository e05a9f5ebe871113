"""Greedy 2D NMS as sequential first-k selection, batched over images.

IoU uses the +1 pixel area convention of the reference NMS kernels.
"""

from __future__ import annotations

from typing import Optional

import torch


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

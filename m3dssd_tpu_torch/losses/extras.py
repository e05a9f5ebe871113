"""Auxiliary loss components no config uses, kept for API-surface parity
with the reference package's `losses/extras.py` (its re-derivations of
PointRCNN's DiceLoss, SigmoidFocalClassificationLoss and bin-based
localization loss, and the bin-based center and heading codes).

Names and argument conventions are the reference's, so the same arrays
give the same values. `decode_heading` wraps with `torch.round`, which
rounds half to even as `jnp.round` does.
"""

from __future__ import annotations

import math

import torch

from ..ops.boxes import smooth_l1


def sigmoid_focal_loss(logits, targets, weights=None, gamma=2.0, alpha=0.25):
    """Per-element sigmoid focal loss; targets in {0, 1}; same shape."""
    p = torch.sigmoid(logits)
    ce = torch.logaddexp(torch.zeros_like(logits), logits) - logits * targets
    p_t = targets * p + (1 - targets) * (1 - p)
    a_t = targets * alpha + (1 - targets) * (1 - alpha)
    loss = a_t * (1 - p_t) ** gamma * ce
    if weights is not None:
        loss = loss * weights
    return loss


def dice_loss(logits, targets, eps=1e-7):
    """Soft Dice loss on sigmoid scores."""
    p = torch.sigmoid(logits).reshape(-1)
    t = targets.reshape(-1).to(p.dtype)
    inter = torch.sum(p * t)
    return 1.0 - (2 * inter + eps) / (torch.sum(p) + torch.sum(t) + eps)


def encode_bin(value, search_range, num_bins):
    """Value in [-range, range) -> (bin id int32, normalised intra-bin
    residual)."""
    bin_size = 2 * search_range / num_bins
    shifted = torch.clamp(value + search_range, 0, 2 * search_range - 1e-4)
    bin_id = torch.floor(shifted / bin_size).to(torch.int32)
    residual = (shifted - (bin_id.to(value.dtype) + 0.5) * bin_size) \
        / (bin_size / 2)
    return bin_id, residual


def decode_bin(bin_id, residual, search_range, num_bins):
    bin_size = 2 * search_range / num_bins
    center = (bin_id.to(residual.dtype) + 0.5) * bin_size - search_range
    return center + residual * (bin_size / 2)


def encode_heading(angle, num_bins=12):
    """Angle (-pi, pi] -> (bin, residual), bin centers 2 pi / num_bins
    apart."""
    two_pi = 2 * math.pi
    shifted = torch.remainder(angle + math.pi, two_pi)       # [0, 2pi)
    bin_size = two_pi / num_bins
    bin_id = torch.floor(shifted / bin_size).to(torch.int32)
    residual = (shifted - (bin_id.to(angle.dtype) + 0.5) * bin_size) \
        / (bin_size / 2)
    return bin_id, residual


def decode_heading(bin_id, residual, num_bins=12):
    two_pi = 2 * math.pi
    bin_size = two_pi / num_bins
    shifted = (bin_id.to(residual.dtype) + 0.5) * bin_size \
        + residual * (bin_size / 2)
    a = shifted - math.pi
    return a - torch.round(a / two_pi) * two_pi


def bin_based_reg_loss(bin_logits, residual_pred, gt_value, search_range,
                       num_bins, mask=None):
    """Cross-entropy over the bins plus smooth-L1 on the gt bin's residual
    head, one dimension. bin_logits and residual_pred [..., num_bins];
    returns a scalar (the mean, or over `mask`)."""
    gt_bin, gt_res = encode_bin(gt_value, search_range, num_bins)
    idx = gt_bin.long()[..., None]
    logp = torch.log_softmax(bin_logits, dim=-1)
    cls_loss = -torch.gather(logp, -1, idx)[..., 0]
    res_pred = torch.gather(residual_pred, -1, idx)[..., 0]
    loss = cls_loss + smooth_l1(res_pred, gt_res)
    if mask is not None:
        m = mask.to(loss.dtype)
        return torch.sum(loss * m) / torch.clamp(torch.sum(m), min=1e-9)
    return torch.mean(loss)

"""3D detection: network forward, box decode and greedy NMS, on one device.

`make_batch_detector` returns `detect(images [B,H,W,3], scale_factors [B])
-> dets [B, nms_topN_post, 14]` (DET_COLS). Rows whose score is -1 are
padding: their NMS slot was unused, and, as in the reference package, they
carry the boxes of anchor index 0. `make_detector` is the single-image form
with the reference's optional top-k pre-NMS cut (`use_topk_pre`).

Every anchor is decoded and NMS runs as first-k selection over all of them
(ops/nms.py). The sparse pre-NMS compaction (`nms_sparse_topm`) and bitmask
NMS of the reference package are not in the port yet; configs that enable
them are refused.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.boxes import bbox_transform_inv_t, decode_bbox_3d_t
from ..ops.nms import nms_select_t
from ..utils.device import resolve_device

# detection table columns
DET_COLS = ["x1", "y1", "x2", "y2", "score", "cls",
            "x3d", "y3d", "z3d", "w3d", "h3d", "l3d", "ry3d", "tracker"]


def _nms_cfg(conf) -> Optional[float]:
    """The NMS early-stop score: conf.score_thres when nms_score_stop is on
    (the KITTI result writer drops rows below score_thres, so stopping
    there is exact),
    else None."""
    thresh = float(getattr(conf, "score_thres", 0.0))
    if getattr(conf, "nms_score_stop", False) and thresh > 0.0:
        return thresh
    return None


def _clip_dets_2d(box, scale_factors, test_scale):
    """Clamp post-NMS 2D boxes [B, 4, K] (original resolution) to the
    original image bounds, derived from the network input size and the
    per-image scale factors [B]."""
    sf = scale_factors[:, None]
    im_h = test_scale[0] / sf - 1.0
    im_w = test_scale[1] / sf - 1.0
    lim = [im_w, im_h, im_w, im_h]
    return torch.stack([torch.minimum(box[:, i].clamp(min=0.0), lim[i])
                        for i in range(4)], dim=1)


class _Decoder:
    """Per-anchor constants on the device, and decode + NMS + dets table."""

    def __init__(self, conf, rois: np.ndarray, device: torch.device):
        if int(getattr(conf, "nms_sparse_topm", 0)) > 0:
            raise NotImplementedError(
                "nms_sparse_topm > 0: the sparse pre-NMS path is not ported")
        f32 = torch.float32
        self.rois_t = torch.as_tensor(rois[:, :5].T, dtype=f32, device=device)
        tracker = rois[:, 4].astype(np.int64)
        self.src3d_t = torch.as_tensor(
            np.asarray(conf.anchors)[tracker, 4:9].T, dtype=f32, device=device)
        self.means = torch.as_tensor(np.asarray(conf.bbox_means).reshape(-1),
                                     dtype=f32, device=device)
        self.stds = torch.as_tensor(np.asarray(conf.bbox_stds).reshape(-1),
                                    dtype=f32, device=device)
        self.top_post = int(conf.nms_topN_post)
        self.nms_thres = float(conf.nms_thres)
        self.nms_stop = _nms_cfg(conf)
        self.clip_boxes = bool(getattr(conf, "clip_boxes", False))
        self.test_scale = tuple(int(s) for s in conf.test_scale)

    def finish(self, scores, cls_pred, rk, sk, d2, d3, sfs):
        """scores, cls_pred [B,N]; rk [5,N] rois; sk [5,N] 3D priors;
        d2 [B,4,N]; d3 [B,7,N]; sfs [B] -> dets [B, top_post, 14]."""
        sf = sfs[:, None, None]
        coords_2d = bbox_transform_inv_t(rk, d2, self.means[0:4],
                                         self.stds[0:4]) / sf
        coords_3d = decode_bbox_3d_t(rk, d3, sk, self.means, self.stds)
        coords_3d = torch.cat([coords_3d[:, 0:2] / sf, coords_3d[:, 2:]], 1)
        fi, valid = nms_select_t(coords_2d, scores, self.nms_thres,
                                 self.top_post, stop_below=self.nms_stop)
        B, K = fi.shape
        final_scores = torch.where(valid, scores.gather(1, fi), -1.0)
        final_2d = coords_2d.gather(2, fi[:, None, :].expand(B, 4, K))
        if self.clip_boxes:
            final_2d = _clip_dets_2d(final_2d, sfs, self.test_scale)
        final_3d = coords_3d.gather(2, fi[:, None, :].expand(B, 7, K))
        return torch.cat([
            final_2d.transpose(1, 2),
            final_scores[..., None],
            cls_pred.to(torch.float32).gather(1, fi)[..., None],
            final_3d.transpose(1, 2),
            rk[4][fi][..., None]], dim=-1)


def make_batch_detector(conf, rois: np.ndarray, model, packed_input: bool = False,
                        device=None):
    """Batched detector: `detect(images, scale_factors) -> [B, top_post, 14]`.

    images [B, H, W, 3] preprocessed (or, with `packed_input`, their
    space-to-depth packing [B, H/2, W/2, 12]); scale_factors [B]. Runs on
    the card unless `device` names another device; the model is moved
    there.
    """
    dev = resolve_device(device)
    model = model.to(dev).eval()
    dec = _Decoder(conf, rois, dev)

    @torch.inference_mode()
    def detect(images, scale_factors):
        out = model(torch.as_tensor(images, device=dev), packed=packed_input)
        sfs = torch.as_tensor(scale_factors, dtype=torch.float32,
                              device=dev).reshape(-1)
        return dec.finish(out["scores"], out["cls_pred"], dec.rois_t,
                          dec.src3d_t, out["bbox_2d"], out["bbox_3d"], sfs)

    return detect


def make_detector(conf, rois: np.ndarray, model, use_topk_pre: bool = False,
                  packed_input: bool = False, device=None):
    """Single-image detector: `detect(image [1,H,W,3], scale_factor) ->
    [top_post, 14]`.

    `use_topk_pre=True` keeps only the nms_topN_pre best-scoring anchors
    before decode and NMS (the reference's strict behaviour); the default
    considers every anchor.
    """
    dev = resolve_device(device)
    model = model.to(dev).eval()
    dec = _Decoder(conf, rois, dev)
    top_pre = int(min(conf.nms_topN_pre, rois.shape[0]))

    @torch.inference_mode()
    def detect(image, scale_factor):
        out = model(torch.as_tensor(image, device=dev), packed=packed_input)
        sfs = torch.as_tensor(scale_factor, dtype=torch.float32,
                              device=dev).reshape(1)
        scores, cls_pred = out["scores"][:1], out["cls_pred"][:1]
        d2, d3 = out["bbox_2d"][:1], out["bbox_3d"][:1]
        rk, sk = dec.rois_t, dec.src3d_t
        if use_topk_pre:
            scores, idx = torch.topk(scores, top_pre, dim=1)
            cls_pred = cls_pred.gather(1, idx)
            d2, d3 = d2[:, :, idx[0]], d3[:, :, idx[0]]
            rk, sk = rk[:, idx[0]], sk[:, idx[0]]
        return dec.finish(scores, cls_pred, rk, sk, d2, d3, sfs)[0]

    return detect

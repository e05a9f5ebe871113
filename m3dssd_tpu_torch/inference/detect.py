"""3D detection: network forward, box decode and greedy NMS, on one device.

`make_batch_detector` returns `detect(images [B,H,W,3], scale_factors [B])
-> dets [B, nms_topN_post, 14]` (DET_COLS). Rows whose score is -1 are
padding: their NMS slot was unused, and, as in the reference package, they
carry the boxes of anchor index 0. `make_detector` is the single-image form
with the reference's optional top-k pre-NMS cut (`use_topk_pre`).

By default every anchor is decoded and NMS runs as first-k selection over
all of them: the custom op `m3dssd::nms_first_k` (ops/nms_op.py), the
hand-written kernel on the card and ops/nms.py:nms_select_t on the CPU.
With `nms_sparse_topm > 0` (and a positive `score_thres`) each image
first keeps only the anchors of the positions whose best anchor scores at
least `score_thres`, up to a budget of positions; NMS then runs over
those candidates, by the bitmask fixpoint (`nms_bitmask`) or by first-k
selection. That leaves every row at or above
`score_thres` exactly as the dense path gives it (a sub-threshold box never
suppresses a higher-scoring one). When any image of the batch has more
confident positions than the budget, the whole batch takes the dense path
(`ops/control.py:cond`: eager it reads one flag per batch back, under
torch.export both paths are in the graph).

Each call runs in the profiler span `m3dssd.detect`, the decoder in
`m3dssd.decode_nms`, and inside it `m3dssd.compact`, `m3dssd.decode`,
`m3dssd.nms` (on the CPU one `m3dssd.nms.round` a round) and
`m3dssd.table` (`utils/profiling.py`).

On the card the batched detector paces itself: each call waits, after it
has issued its decode and NMS, for the end of its own model forward
(`sync.detect.inflight`), so at most one call's decode and NMS is queued
when it returns. The card runs that tail while the host issues the next
call, and a caller's clock around a call measures that call, not a queue
of calls the host ran ahead with.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.boxes import bbox_transform_inv_t, decode_bbox_3d_t
from ..ops.compact import first_m_true
from ..ops.control import cond
from ..ops.nms import nms_bitmask_select_t
from ..ops.nms_op import nms_first_k
from ..utils.device import resolve_device
from ..utils.profiling import host_sync, span

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


def _compact_above(scores, thresh: float, m: int):
    """First-m compaction of the entries with score >= thresh, per row.
    scores [..., N] -> (idx [..., m] int64 with sentinel N in unused slots,
    ok [...]: the row's count <= m)."""
    return first_m_true(scores >= thresh, m)


def _compact_positions(scores, A: int, thresh: float, m_pos: int):
    """Anchor indices of every anchor at the first m_pos positions whose
    best anchor scores >= thresh, per image.

    A position below the threshold holds only sub-threshold anchors, so
    dropping it leaves every above-threshold NMS survivor unchanged; a kept
    position keeps all its anchors. Reducing over the A anchors first makes
    the cumsum A times shorter.

    scores [B, N] ((h, w, a) flat) -> (cand [B, m_pos * A] anchor indices
    with sentinel N, ok [B])."""
    B, N = scores.shape
    HW = N // A
    posmax = scores.reshape(B, HW, A).amax(-1)
    pos, ok = _compact_above(posmax, thresh, m_pos)            # sentinel HW
    cand = pos[..., None] * A + torch.arange(A, device=scores.device)
    cand = torch.where(pos[..., None] < HW, cand, N)
    return cand.reshape(B, -1), ok


def _sparse_nms_cfg(conf, rois, use_topk_pre: bool = False):
    """(m_pos, A, thresh) of the sparse pre-NMS compaction, or m_pos = 0
    when it is off. m_pos is the position budget: conf.nms_sparse_topm
    candidate anchors over A anchors per position, at least 16.

    Exact only for consumers that drop rows below conf.score_thres, as the
    test driver does (postprocess_dets); off under use_topk_pre and for a
    threshold <= 0."""
    m = int(getattr(conf, "nms_sparse_topm", 0))
    thresh = float(getattr(conf, "score_thres", 0.0))
    A = int(np.asarray(conf.anchors).shape[0])
    if use_topk_pre or thresh <= 0.0 or m <= 0:
        return 0, A, thresh
    m_pos = min(max(m // A, 16), rois.shape[0] // A)
    return m_pos, A, thresh


def packed_input_eligible(conf) -> bool:
    """True when eval images can be fed space-to-depth packed from the
    host (stem_s2d on and even eval height and width)."""
    h, w = conf.test_scale
    return bool(getattr(conf, "stem_s2d", False) and h % 2 == 0
                and w % 2 == 0)


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


class _Decoder(torch.nn.Module):
    """Per-anchor constants on the device (buffers, so an exported program
    holds them), and decode + NMS + dets table."""

    def __init__(self, conf, rois: np.ndarray, device: torch.device,
                 use_topk_pre: bool = False):
        super().__init__()
        f32 = torch.float32
        tracker = rois[:, 4].astype(np.int64)
        for name, a in (
                ("rois_t", rois[:, :5].T),
                ("src3d_t", np.asarray(conf.anchors)[tracker, 4:9].T),
                ("means", np.asarray(conf.bbox_means).reshape(-1)),
                ("stds", np.asarray(conf.bbox_stds).reshape(-1))):
            self.register_buffer(name, torch.as_tensor(
                np.ascontiguousarray(a), dtype=f32, device=device))
        self.top_post = int(conf.nms_topN_post)
        self.nms_thres = float(conf.nms_thres)
        self.nms_stop = _nms_cfg(conf)
        self.clip_boxes = bool(getattr(conf, "clip_boxes", False))
        self.test_scale = tuple(int(s) for s in conf.test_scale)
        self.sparse_mpos, self.A, self.sparse_thresh = _sparse_nms_cfg(
            conf, rois, use_topk_pre)
        self.use_bitmask = bool(getattr(conf, "nms_bitmask", False))

    def finish(self, scores, cls_pred, rk, sk, d2, d3, sfs,
               bitmask: bool = False):
        """scores, cls_pred [B,N]; rk [5,N] rois and sk [5,N] 3D priors
        (or [5,B,N], per image); d2 [B,4,N]; d3 [B,7,N]; sfs [B] -> dets
        [B, top_post, 14]. `bitmask` resolves NMS by the fixpoint of
        nms_bitmask_select_t (for a compacted candidate set)."""
        sf = sfs[:, None, None]
        with span("m3dssd.decode"):
            coords_2d = bbox_transform_inv_t(rk, d2, self.means[0:4],
                                             self.stds[0:4]) / sf
            coords_3d = decode_bbox_3d_t(rk, d3, sk, self.means, self.stds)
            coords_3d = torch.cat([coords_3d[:, 0:2] / sf, coords_3d[:, 2:]],
                                  1)
        with span("m3dssd.nms"):
            if bitmask:
                fi, valid = nms_bitmask_select_t(coords_2d, scores,
                                                 self.nms_thres,
                                                 self.top_post)
            else:
                fi, valid = nms_first_k(coords_2d, scores, self.nms_thres,
                                        self.top_post, self.nms_stop)
        with span("m3dssd.table"):
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
                rk[4].expand(B, -1).gather(1, fi)[..., None]], dim=-1)

    def finish_sparse(self, idx, scores, cls_pred, d2, d3, sfs):
        """The sparse pre-NMS path over the candidate anchors `idx` [B, M]
        of `_compact_positions` (sentinel N) and every anchor's outputs
        (shapes as in `finish`)."""
        B, N = scores.shape
        # unused slots carry sentinel index N: gather any row, then fill
        hit = idx < N
        safe = torch.where(hit, idx, 0)
        M = idx.shape[1]

        def rows(a, fill):                           # [B, N] -> [B, M]
            return torch.where(hit, a.gather(1, safe), fill)

        def chans(a):                          # [B, P, N] -> [B, P, M]
            P = a.shape[1]
            return torch.where(hit[:, None], a.gather(
                2, safe[:, None, :].expand(B, P, M)), 0.0)

        def consts(a):                         # [P, N] -> [P, B, M]
            return torch.where(hit, a[:, safe], 0.0)

        with span("m3dssd.compact"):
            sc = rows(scores.to(torch.float32), -1.0)
            ck = rows(cls_pred.to(torch.float32), 0.0)
            cand = (consts(self.rois_t), consts(self.src3d_t), chans(d2),
                    chans(d3))
        return self.finish(sc, ck, *cand, sfs, bitmask=self.use_bitmask)

    def forward(self, out, sfs):
        """Decode + NMS of the model outputs `out` of a batch."""
        with span("m3dssd.decode_nms"):
            return self._decode_nms(out, sfs)

    def _decode_nms(self, out, sfs):
        scores, cls_pred = out["scores"], out["cls_pred"]
        d2, d3 = out["bbox_2d"], out["bbox_3d"]

        def dense(scores, cls_pred, d2, d3, sfs):
            return self.finish(scores, cls_pred, self.rois_t, self.src3d_t,
                               d2, d3, sfs)

        if not self.sparse_mpos:
            return dense(scores, cls_pred, d2, d3, sfs)
        with span("m3dssd.compact"):
            idx, oks = _compact_positions(scores, self.A, self.sparse_thresh,
                                          self.sparse_mpos)
        return cond(oks.all(),
                    lambda *a: self.finish_sparse(idx, *a), dense,
                    (scores, cls_pred, d2, d3, sfs), site="decode.sparse")


def make_batch_detector(conf, rois: np.ndarray, model, packed_input: bool = False,
                        device=None):
    """Batched detector: `detect(images, scale_factors) -> [B, top_post, 14]`.

    images [B, H, W, 3] preprocessed (or, with `packed_input`, their
    space-to-depth packing [B, H/2, W/2, 12]); scale_factors [B]. Runs on
    the card unless `device` names another device; the model is moved
    there, and `detect.device` names it. It takes no mesh: under data
    parallelism every rank runs its own detector on whole batches
    (`test_driver.test_kitti_3d(mesh=...)` deals the batches out), and a
    model built on a mesh's spatial or model axis (`build(mesh=...)`)
    runs them inside its forward, on the weights' shards in place. On the
    card a call returns once its model forward has run, with its decode
    and NMS still queued (the pacing in the module note).
    """
    dev = resolve_device(device)
    model = model.to(dev).eval()
    dec = _Decoder(conf, rois, dev)
    paced = dev.type == "cuda"

    @torch.inference_mode()
    def detect(images, scale_factors):
        with span("m3dssd.detect"):
            out = model(torch.as_tensor(images, device=dev),
                        packed=packed_input)
            if paced:
                forward_done = torch.cuda.Event()
                forward_done.record()
            sfs = torch.as_tensor(scale_factors, dtype=torch.float32,
                                  device=dev).reshape(-1)
            dets = dec(out, sfs)
            if paced:
                with host_sync("detect.inflight"):
                    forward_done.synchronize()
            return dets

    detect.device = dev
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
    dec = _Decoder(conf, rois, dev, use_topk_pre=use_topk_pre)
    top_pre = int(min(conf.nms_topN_pre, rois.shape[0]))

    @torch.inference_mode()
    def detect(image, scale_factor):
        with span("m3dssd.detect"):
            return _detect(image, scale_factor)

    def _detect(image, scale_factor):
        out = model(torch.as_tensor(image, device=dev), packed=packed_input)
        sfs = torch.as_tensor(scale_factor, dtype=torch.float32,
                              device=dev).reshape(1)
        out = {k: out[k][:1] for k in ("scores", "cls_pred", "bbox_2d",
                                       "bbox_3d")}
        if not use_topk_pre:
            return dec(out, sfs)[0]
        with span("m3dssd.decode_nms"):
            scores, idx = torch.topk(out["scores"], top_pre, dim=1)
            cls_pred = out["cls_pred"].gather(1, idx)
            d2 = out["bbox_2d"][:, :, idx[0]]
            d3 = out["bbox_3d"][:, :, idx[0]]
            rk, sk = dec.rois_t[:, idx[0]], dec.src3d_t[:, idx[0]]
            return dec.finish(scores, cls_pred, rk, sk, d2, d3, sfs)[0]

    detect.device = dev
    return detect

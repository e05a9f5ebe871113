"""Feature alignment: shape-align and center-align (k = 1 paths).

Both compute *derived* deformable offsets from the classification
confidence and the box regressions and apply a DCNv2 with them, plus a
residual:

  * ShapeAlign — per-anchor offsets spreading the 3x3 taps over the most
    confident anchor's width/height.
  * CenterAlign — the predicted delta-x/delta-y regressions, un-whitened and
    converted to feature-map pixels, shift a 1x1 deformable tap toward the
    object center.

Offsets are masked by `max anchor confidence > thresh`; elsewhere the DCN
collapses to `mask * conv(x) + bias`. With a `SparseSel` the modules compute
that dense base everywhere and correct it by the deformable gather at the
(up to M) confident positions; when more than M positions are confident
they run the full dense DCN instead. Exact in both regimes. The choice is
`ops/control.py:cond`: eager each module reads the overflow flag back
(counted as `sync.<site>`, and the dense side as `fallback.<site>`), under
torch.export it is a `torch.cond` over both paths. The selection runs in
the profiler span `m3dssd.align.select`, each module in
`m3dssd.<site>`.

Layouts: features x are NCHW (channels_last); the per-anchor confidence and
regressions are [B, H, W, A]. The DCN mask is the soft max confidence.
Under autograd, gradients reach x and the modules' weights only: the
confidence and the box regressions that place the taps are detached, as in
the reference package. Under the model axis a module computes its own
output channels of the aligned map and gathers them before the residual.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn

from ..ops.compact import first_m_true
from ..ops.control import cond
from ..ops.dcn import bilinear_sample_rows, dcn_v2
from ..parallel import model_axis
from ..utils.profiling import span


class SparseSel(NamedTuple):
    """Top-M confident-position selection shared by the align modules."""
    pos: Optional[torch.Tensor]  # [M] flat B*H*W indices; B*H*W = unused
    # every confident position fits in M: a one-element bool tensor
    ok: Optional[torch.Tensor]
    mask: torch.Tensor           # [B,H,W,1] max anchor confidence
    ind: torch.Tensor            # [B,H,W] argmax anchor


def confident_topm(prob, thresh: float, m_per_image: int) -> SparseSel:
    """Select (up to) the first M = m_per_image*B confident positions, in
    order of appearance. prob [B,H,W,A] (no gradient flows through it)."""
    B, H, W, A = prob.shape
    with span("m3dssd.align.select"):
        mask, ind = torch.max(prob.detach(), dim=-1, keepdim=True)
        M = int(min(m_per_image * B, B * H * W))
        pos, ok = first_m_true((mask[..., 0] > thresh).reshape(-1), M)
    return SparseSel(pos, ok, mask, ind[..., 0])


def _anchor_max(prob) -> SparseSel:
    mask, ind = torch.max(prob.detach(), dim=-1, keepdim=True)
    return SparseSel(None, None, mask, ind[..., 0])


def _flat_coords(pos, B: int, H: int, W: int):
    """pos [M] flat B*H*W indices -> (b, y, x)."""
    HW = H * W
    bi = pos // HW
    rem = pos - bi * HW
    yy = rem // W
    return bi, yy, rem - yy * W


def _scatter_rows(dense, pos, val):
    """dense [B*H*W, C] with rows `pos` replaced by `val`; sentinel
    positions (B*H*W) land in a spare row that is cut off."""
    spare = dense.new_zeros((1, dense.shape[1]))
    out = torch.cat([dense, spare]).index_copy(0, pos, val.to(dense.dtype))
    return out[:-1]


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _nchw(y):
    return y.permute(0, 3, 1, 2)


def _enter(x, shard):
    """The aligned map's input: under the model axis every rank's output
    channels read all of x (parallel/model_axis.py)."""
    return x if shard is None else model_axis.copy_to(x, shard)


def _out(y, shard):
    """This rank's output channels -> all of them."""
    return y if shard is None else model_axis.gather(y, shard)


class ShapeAlign(nn.Module):
    """Anchor-shape-driven 3x3 deformable alignment."""

    def __init__(self, features: int, anchors: np.ndarray, feat_stride: int,
                 kernel: int = 3, thresh: float = 0.5):
        super().__init__()
        K = kernel
        anchors = np.asarray(anchors)
        A = anchors.shape[0]
        h_step = (anchors[:, 3] - anchors[:, 1]) / feat_stride / K
        w_step = (anchors[:, 2] - anchors[:, 0]) / feat_stride / K
        off = np.zeros([A, K * K, 2], dtype=np.float32)
        for i in range(K):
            for j in range(K):
                t = i * K + j
                off[:, t, 0] = (h_step - 1) * (i - K / 2 + 0.5)
                off[:, t, 1] = (w_step - 1) * (j - K / 2 + 0.5)
        self.register_buffer("anchor_offsets", torch.from_numpy(off),
                             persistent=False)
        self.kernel = K
        self.thresh = thresh
        self.weight = nn.Parameter(torch.empty(K, K, features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    model_shard = None
    site = "align.shape"

    def forward(self, x, prob, sparse_sel: Optional[SparseSel] = None):
        with span("m3dssd." + self.site):
            return self._forward(x, prob, sparse_sel)

    def _forward(self, x, prob, sparse_sel: Optional[SparseSel]):
        xin = _enter(x, self.model_shard)
        if sparse_sel is None:
            return _out(self._dense(xin, _anchor_max(prob)),
                        self.model_shard) + x
        sel = sparse_sel
        aligned = cond(sel.ok,
                       lambda x: self._sparse_correct(self._base(x, sel), x,
                                                      sel),
                       lambda x: self._dense(x, sel), (xin,), site=self.site)
        return _out(aligned, self.model_shard) + x

    def _dense(self, x, sel: SparseSel):
        """Full-map deformable path."""
        xh = _nhwc(x)
        B, H, W, C = xh.shape
        KK = self.kernel * self.kernel
        hard = (sel.mask > self.thresh).to(x.dtype)
        table = self.anchor_offsets.reshape(-1, KK * 2).to(x.dtype)
        offset = (table[sel.ind] * hard).reshape(B, H, W, KK, 2)
        dcn_mask = sel.mask.expand(B, H, W, KK).to(x.dtype)
        y = dcn_v2(xh, offset, dcn_mask, self.weight.to(x.dtype),
                   self.bias.to(x.dtype), stride=1, padding=self.kernel // 2)
        return _nchw(y)

    def _base(self, x, sel: SparseSel):
        """The zero-offset collapse `mask * conv3x3(x) + b` (NCHW)."""
        w = self.weight.to(x.dtype).permute(3, 2, 0, 1)    # OIHW
        base = torch.nn.functional.conv2d(x, w, padding=self.kernel // 2)
        return (_nchw(sel.mask).to(x.dtype) * base
                + self.bias.to(x.dtype)[None, :, None, None])

    def _sparse_correct(self, dense, x, sel: SparseSel):
        """Deformable correction of `dense` at the selected positions."""
        xh = _nhwc(x).contiguous()
        B, H, W, C = xh.shape
        K = self.kernel
        KK = K * K
        pad = K // 2
        f32 = torch.float32
        pos = sel.pos
        M = pos.shape[0]
        bi, yy, xx = _flat_coords(pos, B, H, W)
        posc = pos.clamp(max=B * H * W - 1)
        ind_p = sel.ind.reshape(-1)[posc]
        mask_p = sel.mask.reshape(-1)[posc]
        off_p = self.anchor_offsets.reshape(-1, KK, 2)[ind_p]   # [M,KK,2]
        tap_y = torch.arange(K, dtype=f32, device=x.device).repeat_interleave(K)
        tap_x = torch.arange(K, dtype=f32, device=x.device).repeat(K)
        py = (yy.to(f32)[:, None] - pad + tap_y[None, :]) + off_p[..., 0]
        px = (xx.to(f32)[:, None] - pad + tap_x[None, :]) + off_p[..., 1]
        sampled = bilinear_sample_rows(xh, bi, py, px)          # [M,KK,C]
        cols = (sampled * mask_p[:, None, None].to(x.dtype)).reshape(M, KK * C)
        acc = torch.promote_types(x.dtype, f32)
        val = torch.matmul(cols.to(acc),
                           self.weight.to(x.dtype).reshape(KK * C, -1).to(acc))
        val = val.to(x.dtype) + self.bias.to(x.dtype)
        flat = _nhwc(dense).reshape(B * H * W, -1)
        return _nchw(_scatter_rows(flat, pos, val).reshape(B, H, W, -1))


class CenterAlign(nn.Module):
    """Regression-driven 1x1 deformable alignment."""

    def __init__(self, features: int, anchors: np.ndarray, xy_mean, xy_std,
                 feat_stride: int, thresh: float = 0.5,
                 site: str = "align.center2d"):
        super().__init__()
        self.site = site
        anchors = np.asarray(anchors)
        self.register_buffer("anchor_w", torch.as_tensor(
            (anchors[:, 2] - anchors[:, 0]) / feat_stride, dtype=torch.float32),
            persistent=False)
        self.register_buffer("anchor_h", torch.as_tensor(
            (anchors[:, 3] - anchors[:, 1]) / feat_stride, dtype=torch.float32),
            persistent=False)
        self.register_buffer("xy_mean", torch.as_tensor(
            np.asarray(xy_mean), dtype=torch.float32), persistent=False)
        self.register_buffer("xy_std", torch.as_tensor(
            np.asarray(xy_std), dtype=torch.float32), persistent=False)
        self.thresh = thresh
        self.weight = nn.Parameter(torch.empty(1, 1, features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    model_shard = None

    def forward(self, x, bbox_x, bbox_y, prob,
                sparse_sel: Optional[SparseSel] = None):
        """bbox_x / bbox_y: per-anchor whitened delta predictions
        [B,H,W,A]."""
        with span("m3dssd." + self.site):
            return self._forward(x, bbox_x, bbox_y, prob, sparse_sel)

    def _forward(self, x, bbox_x, bbox_y, prob,
                 sparse_sel: Optional[SparseSel]):
        xin = _enter(x, self.model_shard)
        if sparse_sel is None:
            return _out(self._dense(xin, bbox_x, bbox_y, prob),
                        self.model_shard) + x
        sel = sparse_sel
        aligned = cond(sel.ok,
                       lambda x, bx, by: self._sparse_correct(
                           self._base(x, sel), x, bx, by, sel),
                       lambda x, bx, by: self._dense(x, bx, by, prob),
                       (xin, bbox_x, bbox_y), site=self.site)
        return _out(aligned, self.model_shard) + x

    def _offsets(self, bx, by, ind):
        """Un-whitened center offsets in feature pixels of anchor `ind`."""
        off_x = (bx * self.xy_std[0] + self.xy_mean[0]) * self.anchor_w[ind]
        off_y = (by * self.xy_std[1] + self.xy_mean[1]) * self.anchor_h[ind]
        return off_y, off_x

    def _dense(self, x, bbox_x, bbox_y, prob):
        xh = _nhwc(x)
        B, H, W, C = xh.shape
        sel = _anchor_max(prob)
        ind = sel.ind[..., None]
        bx = bbox_x.detach().to(torch.float32).gather(-1, ind)[..., 0]
        by = bbox_y.detach().to(torch.float32).gather(-1, ind)[..., 0]
        off_y, off_x = self._offsets(bx, by, sel.ind)
        hard = (sel.mask > self.thresh).to(torch.float32)
        offset = (torch.stack([off_y, off_x], dim=-1) * hard)
        offset = offset[:, :, :, None, :].to(x.dtype)          # [B,H,W,1,2]
        dcn_mask = sel.mask.to(x.dtype)                        # [B,H,W,1]
        y = dcn_v2(xh, offset, dcn_mask, self.weight.to(x.dtype),
                   self.bias.to(x.dtype), stride=1, padding=0)
        return _nchw(y)

    def _base(self, x, sel: SparseSel):
        """The zero-offset collapse `mask * (x @ W) + b`, NO gather."""
        xh = _nhwc(x)
        B, H, W, C = xh.shape
        acc = torch.promote_types(x.dtype, torch.float32)
        w = self.weight.to(x.dtype).reshape(C, -1)
        base = torch.matmul(xh.reshape(B * H * W, C).to(acc), w.to(acc))
        out = (sel.mask.reshape(-1, 1).to(x.dtype) * base.to(x.dtype)
               + self.bias.to(x.dtype))
        return _nchw(out.reshape(B, H, W, -1))

    def _sparse_correct(self, dense, x, bbox_x, bbox_y, sel: SparseSel):
        xh = _nhwc(x).contiguous()
        B, H, W, C = xh.shape
        f32 = torch.float32
        pos = sel.pos
        posc = pos.clamp(max=B * H * W - 1)
        bi, yy, xx = _flat_coords(pos, B, H, W)
        A = bbox_x.shape[-1]
        ind_p = sel.ind.reshape(-1)[posc]
        mask_p = sel.mask.reshape(-1)[posc]
        bx = bbox_x.detach().to(f32).reshape(-1, A)[posc] \
            .gather(1, ind_p[:, None])[:, 0]
        by = bbox_y.detach().to(f32).reshape(-1, A)[posc] \
            .gather(1, ind_p[:, None])[:, 0]
        off_y, off_x = self._offsets(bx, by, ind_p)
        py = yy.to(f32) + off_y
        px = xx.to(f32) + off_x
        sampled = bilinear_sample_rows(xh, bi, py[:, None], px[:, None])[:, 0]
        acc = torch.promote_types(x.dtype, f32)
        w = self.weight.to(x.dtype).reshape(C, -1)
        val = torch.matmul((sampled * mask_p[:, None].to(x.dtype)).to(acc),
                           w.to(acc))
        val = val.to(x.dtype) + self.bias.to(x.dtype)
        flat = _nhwc(dense).reshape(B * H * W, -1)
        return _nchw(_scatter_rows(flat, pos, val).reshape(B, H, W, -1))

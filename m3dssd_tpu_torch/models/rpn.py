"""The M3DSSD RPN head and model factory.

One shared stride-8 feature map feeds 12 regression towers and one
classification tower; shape/center alignment and ANAB depth attention sit
between them.

Output contract (eval):
    cls, prob [B,N,C]; cls_t, prob_t [B,C,N]; lse, scores, cls_pred [B,N];
    bbox_2d [B,4,N] and bbox_3d [B,7,N] (channel-major); feat_size (H, W)
with N = H*W*A flattened in (h, w, a) order to match
`anchors.locate_anchors`, and the class channel of the classification map at
index a*C + c.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ..utils.device import resolve_device
from ..utils.profiling import span
from .align import CenterAlign, ShapeAlign, confident_topm
from .attention import ANAB
from .layers import BatchNorm2d, BilinearUpsample, batch_norm, \
    bilinear_upsample_kernel, conv2d, conv_bn, leaky_relu
from .necks import DCN, DeformLocConv, DLASeg


def flatten_anchor_map(x):
    """Head map [B, A, H, W] -> [B, H*W*A] in (h, w, a) order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def _anchor_last(x):
    """[B, A, H, W] -> [B, H, W, A]."""
    return x.permute(0, 2, 3, 1)


class Tower(nn.Module):
    """conv(first_kernel) -> BN -> LReLU -> conv1x1 -> BN -> LReLU ->
    conv1x1."""

    def __init__(self, cin: int, out_features: int, hidden: int = 256,
                 first_kernel: int = 1):
        super().__init__()
        self.Conv_0 = conv2d(cin, hidden, first_kernel)
        self.BatchNorm_0 = batch_norm(hidden)
        self.Conv_1 = conv2d(hidden, hidden, 1)
        self.BatchNorm_1 = batch_norm(hidden)
        self.Conv_2 = conv2d(hidden, out_features, 1)

    def forward(self, x):
        x = conv_bn(self.Conv_0, self.BatchNorm_0, x, act=True)
        x = conv_bn(self.Conv_1, self.BatchNorm_1, x, act=True)
        return self.Conv_2(x)


_REG_TOWERS = ("bbox_x", "bbox_y", "bbox_w", "bbox_h", "bbox_x3d",
               "bbox_y3d", "bbox_z3d", "bbox_w3d", "bbox_h3d", "bbox_l3d",
               "bbox_rY3d")


class M3DRPN(nn.Module):
    """Backbone + 13 towers + alignment + ANAB."""

    def __init__(self, num_classes: int, anchors: np.ndarray,
                 bbox_means: Optional[np.ndarray],
                 bbox_stds: Optional[np.ndarray], back_bone: str = "dla102",
                 feat_stride: int = 8, attention: Optional[str] = None,
                 center_align: bool = False, shape_align: bool = False,
                 ida_dcnv2: bool = True, dcn_shift_clamp: Optional[float] = 1.0,
                 head_hidden: int = 256, sparse_align_topm: int = 0,
                 align_thresh: float = 0.5, sparse_align_train: bool = False):
        super().__init__()
        anchors = np.asarray(anchors)
        A = anchors.shape[0]
        self.num_classes = num_classes
        self.num_anchors = A
        self.attention = attention
        self.sparse_align_topm = sparse_align_topm
        self.sparse_align_train = sparse_align_train
        self.align_thresh = align_thresh
        self.base = DLASeg(back_bone, down_ratio=feat_stride,
                           use_dcn=ida_dcnv2, shift_clamp=dcn_shift_clamp)
        ch = self.base.out_channels
        self.cls_tower = Tower(ch, A * num_classes, head_hidden, 3)
        for name in _REG_TOWERS:
            self.add_module(name, Tower(ch, A, head_hidden, 1))
        self.shape_align_mod = (ShapeAlign(ch, anchors, feat_stride, 3,
                                           align_thresh)
                                if shape_align else None)
        if center_align:
            self.center_align2d = CenterAlign(
                ch, anchors, bbox_means[0:2], bbox_stds[0:2], feat_stride,
                align_thresh)
            self.center_align3d = CenterAlign(
                ch, anchors, bbox_means[4:6], bbox_stds[4:6], feat_stride,
                align_thresh, site="align.center3d")
        else:
            self.center_align2d = self.center_align3d = None
        if attention == "ANAB":
            self.anab = ANAB(ch)
            self.anab_bn = batch_norm(ch)

    def forward(self, images, packed: bool = False) -> Dict[str, torch.Tensor]:
        """images [B, H, W, 3] (NHWC), or with `packed` their space-to-depth
        packing [B, H/2, W/2, 12]. Runs in the profiler spans
        `m3dssd.backbone` (DLASeg) and `m3dssd.head` (the rest)."""
        with span("m3dssd.backbone"):
            x, on_slabs = self.base.forward_rows(images, packed=packed)
        with span("m3dssd.head"):
            return self._head(x, on_slabs)

    def _head(self, x, on_slabs: bool) -> Dict[str, torch.Tensor]:
        """Towers, softmax, selection, alignment, ANAB and the outputs of
        the stride-8 feature map x [B, C, H, W]."""
        B, _, H, W = x.shape
        A, NC = self.num_anchors, self.num_classes

        cls = _anchor_last(self.cls_tower(x)).reshape(B, H, W, A, NC)
        # class-wise slices [B,H,W,A] in float32
        sl = [cls[..., c].to(torch.float32) for c in range(NC)]
        m_all = functools.reduce(torch.maximum, sl)
        ex = [torch.exp(s - m_all) for s in sl]
        z = sum(ex)
        lse = m_all + torch.log(z)
        prob_sl = [e / z for e in ex]
        prob = torch.stack(prob_sl, dim=-1)                # [B,H,W,A,C]
        fg_prob = (1.0 - prob_sl[0]).to(x.dtype)           # [B,H,W,A]

        m_fg = functools.reduce(torch.maximum, sl[1:])
        det_scores = torch.exp(m_fg - m_all) / z           # max fg softmax
        det_cls = torch.zeros_like(m_fg)
        best = sl[1]
        for c in range(2, NC):
            take = sl[c] > best
            det_cls = torch.where(take, float(c - 1), det_cls)
            best = torch.maximum(best, sl[c])
        det_cls = det_cls + 1.0                            # class ids 1..C-1

        sel = None
        if (self.sparse_align_topm > 0
                and (self.shape_align_mod is not None
                     or self.center_align2d is not None)
                and (not self.training or self.sparse_align_train)):
            sel = confident_topm(fg_prob, self.align_thresh,
                                 self.sparse_align_topm)

        feats = (self.shape_align_mod(x, fg_prob, sparse_sel=sel)
                 if self.shape_align_mod is not None else x)
        bbox_x = self.bbox_x(feats)
        bbox_y = self.bbox_y(feats)
        feats2d = (self.center_align2d(feats, _anchor_last(bbox_x),
                                       _anchor_last(bbox_y), fg_prob,
                                       sparse_sel=sel)
                   if self.center_align2d is not None else feats)
        bbox_w = self.bbox_w(feats2d)
        bbox_h = self.bbox_h(feats2d)

        bbox_x3d = self.bbox_x3d(feats)
        bbox_y3d = self.bbox_y3d(feats)
        feats3d = (self.center_align3d(feats, _anchor_last(bbox_x3d),
                                       _anchor_last(bbox_y3d), fg_prob,
                                       sparse_sel=sel)
                   if self.center_align3d is not None else feats)
        bbox_w3d = self.bbox_w3d(feats3d)
        bbox_h3d = self.bbox_h3d(feats3d)
        bbox_l3d = self.bbox_l3d(feats3d)
        bbox_rY3d = self.bbox_rY3d(feats3d)

        feats_z = feats3d
        if self.attention == "ANAB":
            with span("m3dssd.anab"):
                feats_z = leaky_relu(self.anab_bn(self.anab(feats_z)))
        bbox_z3d = self.bbox_z3d(feats_z)

        flat = lambda v: flatten_anchor_map(v).to(torch.float32)
        flat_hwa = lambda v: v.reshape(B, H * W * A)       # [B,H,W,A] -> [B,N]
        return {
            "cls": cls.reshape(B, H * W * A, NC).to(torch.float32),
            "prob": prob.reshape(B, H * W * A, NC),
            "cls_t": torch.stack([flat_hwa(s) for s in sl], dim=1),
            "prob_t": torch.stack([flat_hwa(p) for p in prob_sl], dim=1),
            "lse": flat_hwa(lse),
            "scores": flat_hwa(det_scores),
            "cls_pred": flat_hwa(det_cls),
            "bbox_2d": torch.stack([flat(bbox_x), flat(bbox_y),
                                    flat(bbox_w), flat(bbox_h)], dim=1),
            "bbox_3d": torch.stack([flat(bbox_x3d), flat(bbox_y3d),
                                    flat(bbox_z3d), flat(bbox_w3d),
                                    flat(bbox_h3d), flat(bbox_l3d),
                                    flat(bbox_rY3d)], dim=1),
            "feat_size": (H, W),
            "on_slabs": on_slabs,
        }


def bias_background(model: M3DRPN, num_classes: int, bias: float = 4.0):
    """Raise the classification tower's background-logit bias by `bias`, in
    place, and return the model.

    A freshly initialised softmax puts P(bg) ~= 1/num_classes at every
    position; a trained detector has P(bg) -> ~1 almost everywhere, the
    regime the sparse alignment path sees in deployment. bias=4.0 gives
    P(bg) ~= e^4/(e^4 + C-1) ~= 0.95.
    """
    conv = model.cls_tower.Conv_2
    first = 0
    if conv.model_shard is not None:      # this rank's slice of the bias
        first = conv.model_shard.index * conv.bias.numel()
    with torch.no_grad():
        conv.bias[(-first) % num_classes::num_classes] += bias
    return model


# ---------------------------------------------------------------------------
# Initialisation (the reference package's initializers, from a seeded
# torch.Generator)
# ---------------------------------------------------------------------------

def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator):
    """Truncated normal in [-2, 2] std, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """(Re)initialise every parameter and BN buffer: convs lecun-normal
    with zero bias, BN identity, DCN and align weights variance-scaled
    uniform (1/3, fan-in) with zero offset/mask convs, upsampling
    bilinear."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BilinearUpsample):
                mod.weight.copy_(bilinear_upsample_kernel(
                    mod.stride[0], mod.weight.shape[0]))
            elif isinstance(mod, nn.Conv2d):
                fan_in = mod.weight[0].numel()
                _lecun_normal_(mod.weight, fan_in, generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.BatchNorm2d):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
                mod.num_batches_tracked.zero_()
            elif isinstance(mod, (DCN, ShapeAlign, CenterAlign)):
                K, _, cin, _ = mod.weight.shape
                bound = math.sqrt(3.0 * (1.0 / 3.0) / (K * K * cin))
                nn.init.uniform_(mod.weight, -bound, bound,
                                 generator=generator)
                mod.bias.zero_()
            elif isinstance(mod, DeformLocConv):
                bound = math.sqrt(1.0 / mod.weight[0].numel()
                                  / mod.weight.shape[0])
                nn.init.uniform_(mod.weight, -bound, bound,
                                 generator=generator)
                mod.bias.zero_()
        # after the loop: it visits each DCN's offset conv after the DCN,
        # as a Conv2d, and would draw it again
        for mod in model.modules():
            if isinstance(mod, (DCN, DeformLocConv)):
                mod.conv_offset_mask.weight.zero_()
                mod.conv_offset_mask.bias.zero_()
    return model


def _cast_params(model: nn.Module, dtype: torch.dtype) -> None:
    """Cast parameters and BN statistics to `dtype`; the align modules'
    constant tables stay float32 (offsets are computed in float32)."""
    for mod in model.modules():
        for p in mod.parameters(recurse=False):
            p.data = p.data.to(dtype)
        if isinstance(mod, nn.BatchNorm2d):
            mod.running_mean.data = mod.running_mean.data.to(dtype)
            mod.running_var.data = mod.running_var.data.to(dtype)


def apply_mesh(model: M3DRPN, mesh) -> M3DRPN:
    """Lay `model` out over `mesh` (`parallel.make_mesh`), in place:
    train-mode BatchNorm over the data and spatial ranks in the backbone
    (DLASeg) and over the data ranks in the head (computed whole on every
    spatial rank); DLASeg on this rank's rows under a spatial axis; this
    rank's slice of every leaf the reference's rule shards
    (`parallel/model_axis.py`) under a model axis.

    `model.grad_groups` records each parameter's reduction group for a step
    whose DLASeg ran on slabs (the forward's "on_slabs"): the data and
    spatial ranks for the backbone's, whose gradients are partial per
    spatial rank; the data ranks for the head's."""
    from ..parallel.model_axis import ModelShard, shard_model
    from ..parallel.spatial import SpatialShard

    in_base = {id(m) for m in model.base.modules()}
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.process_group = (mesh.batch_group if id(m) in in_base
                               else mesh.group)
    in_base = {id(p) for p in model.base.parameters()}
    model.grad_groups = {n: (mesh.batch_group if id(p) in in_base
                             else mesh.group)
                         for n, p in model.named_parameters()}
    if mesh.spatial > 1:
        shard = SpatialShard(mesh.s, mesh.spatial, mesh.spatial_group)
        for m in model.base.modules():
            if hasattr(m, "spatial_shard"):
                m.spatial_shard = shard
    if mesh.model > 1:
        shard_model(model, ModelShard(mesh.m, mesh.model, mesh.model_group))
    return model


def build(conf, device=None, seed: int = 0, phase: str = "eval",
          group=None, mesh=None) -> M3DRPN:
    """Build the detector for `conf`, initialised from `seed`.

    Runs on the card unless `device` names another device (`"cpu"` for the
    plain ops); raises when `device` is None and CUDA is absent. Weights are
    drawn on the CPU, so a seed gives the same model on every device.

    phase "eval": eval mode, parameters in conf.compute_dtype and not
    requiring grad. phase "train": train mode, float32 master parameters
    that require grad, computing in conf.compute_dtype (cast at use, as the
    reference's flax modules with param_dtype float32 do); `model.eval()`
    and `model.train()` switch it for an in-training evaluation.

    `group`: the process group of a data axis (`parallel.make_mesh`); its
    BatchNorm layers then take their train-mode statistics over the
    group's global batch (`parallel/sync_bn.py`). `mesh`: a mesh of
    `parallel.make_mesh`, its axes laid out by `apply_mesh` (its data group
    takes `group`'s place).
    """
    if phase not in ("eval", "train"):
        raise ValueError(f"phase {phase!r}: 'eval' or 'train'")
    dev = resolve_device(device)
    if not conf.back_bone.startswith("dla"):
        raise NotImplementedError(f"backbone {conf.back_bone}")
    if conf.anchors is None:
        raise ValueError("conf.anchors is not set (see utils.synthetic_conf)")
    means = None if conf.bbox_means is None else np.asarray(conf.bbox_means)[0]
    stds = None if conf.bbox_stds is None else np.asarray(conf.bbox_stds)[0]
    model = M3DRPN(
        num_classes=conf.num_classes, anchors=np.asarray(conf.anchors),
        bbox_means=means, bbox_stds=stds, back_bone=conf.back_bone,
        feat_stride=conf.feat_stride, attention=conf.attention,
        center_align=conf.center_align, shape_align=conf.shape_align,
        ida_dcnv2=conf.ida_dcnv2, dcn_shift_clamp=conf.dcn_shift_clamp,
        sparse_align_topm=int(conf.sparse_align_topm),
        sparse_align_train=bool(conf.sparse_align_train))
    init_weights(model, torch.Generator().manual_seed(seed))
    if mesh is not None:
        group = None
    if group is not None:
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.process_group = group
    dtype = torch.bfloat16 if conf.compute_dtype == "bfloat16" \
        else torch.float32
    if phase == "train":
        model.train()
        if dtype != torch.float32:
            model.base.base.compute_dtype = dtype
    else:
        model.requires_grad_(False)
        model.eval()
        _cast_params(model, dtype)
    if mesh is not None:
        apply_mesh(model, mesh)
    return model.to(dev)

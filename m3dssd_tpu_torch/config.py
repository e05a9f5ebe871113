"""Typed experiment configuration (the port's own copy).

Same knobs, names and defaults as the reference package's `Config`, so a
configuration means the same thing in both packages. Anchors and bbox
whitening statistics are computed from the training set (or synthesised,
see `utils.synthetic_conf`) and written back onto the config at run time.
Knobs that only steer the JAX package's compiler (remat, custom VJP, loss
layout) are kept so that configs stay interchangeable; the port reads the
ones its modules implement.
"""

from __future__ import annotations

import dataclasses
import pickle
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


@dataclass
class Config:
    # ---------------------------------------------------------------- general
    model: str = "m3d_rpn_align"
    ida_dcnv2: bool = True            # deformable proj/node convs in IDAUp
    # clamp for learned DCN offsets: enables the shifted-MAC form
    # (ops/dcn.py:dcn_v2_shift, the hand-written kernel on the card);
    # None = unbounded gather path
    dcn_shift_clamp: Optional[float] = 1.0
    # the reference package's space-to-depth stem knob; the port always runs
    # the plain stem (same math, same parameters) and only reads whether
    # packed input is eligible (inference/detect.py)
    stem_s2d: bool = True
    attention: Optional[str] = None   # None | "ANAB"

    # feature alignment
    center_align: bool = False
    shape_align: bool = False
    # top-M sparse alignment: the align DCNs only deviate from
    # `mask*conv(x)+b` at positions whose max anchor confidence exceeds the
    # align threshold; with a per-image budget M the deformable gather runs
    # only there, and falls back to the dense DCN if more than M positions
    # are confident (exact in both regimes). 0 disables.
    sparse_align_topm: int = 1024
    sparse_align_train: bool = True

    # backward-pass knobs of the reference package (no effect on the
    # port's forward-only slice)
    remat_dcn: bool = False
    remat_towers: bool = False
    dcn_custom_vjp: bool = False
    loss_light_stats: bool = True
    loss_channel_major: bool = True
    loss_mining_bisect: bool = True

    # ----------------------------------------------------------------- solver
    solver_type: str = "sgd"          # sgd | adam | adamax
    lr: float = 0.004
    momentum: float = 0.9
    weight_decay: float = 0.0005
    max_epoch: int = 70
    warmup: float = 1.0 / 70          # fraction of total iters for linear warmup
    eval_epoch: int = 10
    snapshot_epoch: int = 5
    display_iter: int = 25
    do_test: bool = True

    lr_policy: str = "cos"            # cos | poly | step
    lr_steps: Optional[List[float]] = None
    lr_target: float = 0.004 * 1e-5
    grad_clip_norm: Optional[float] = None

    # gradient accumulation: apply the optimizer update every `batch_skip` steps
    batch_skip: int = 1

    # ----------------------------------------------------------------- random
    rng_seed: int = 2

    # ----------------------------------------------------------------- network
    image_means: List[float] = field(default_factory=lambda: [0.485, 0.456, 0.406])
    image_stds: List[float] = field(default_factory=lambda: [0.229, 0.224, 0.225])
    feat_stride: int = 8
    back_bone: str = "dla102"
    pre_train: bool = True
    has_3d: bool = True

    # compute dtype of the network ("bfloat16" | "float32")
    compute_dtype: str = "bfloat16"

    # ------------------------------------------------------- sampling/dataset
    test_scale: List[int] = field(default_factory=lambda: [384, 1280])
    crop_size: List[int] = field(default_factory=lambda: [384, 1280])
    mirror_prob: float = 0.50
    trans_prob: float = 0.7
    distort_prob: float = -1.0
    shift: float = 0.1
    scale_trans: float = 0.4

    datasets_train: List[Dict[str, Any]] = field(default_factory=lambda: [
        {"name": "kitti_split1", "anno_fmt": "kitti_det", "im_ext": ".png", "scale": 1}])
    datasets_validation: List[Dict[str, Any]] = field(default_factory=lambda: [
        {"name": "kitti_split1", "anno_fmt": "kitti_det", "im_ext": ".png", "scale": 1}])
    datasets_test: List[Dict[str, Any]] = field(default_factory=lambda: [
        {"name": "kitti_split1", "anno_fmt": "kitti_det", "im_ext": ".png", "scale": 1}])
    use_3d_for_2d: bool = True
    num_workers: int = 8

    # multi-frame input: stack `video_count` previous frames as extra channels
    video_det: bool = False
    video_count: int = 1

    percent_anc_h: List[float] = field(default_factory=lambda: [0.0625, 0.75])

    min_gt_vis: float = 0.65
    ilbls: List[str] = field(default_factory=lambda: ["Van", "ignore"])
    lbls: List[str] = field(default_factory=lambda: ["Car", "Pedestrian", "Cyclist"])

    # --------------------------------------------------------------- det sampling
    batch_size: int = 4
    fg_image_ratio: float = 1.0
    box_samples: float = 0.20
    fg_fraction: float = 0.20
    bg_thresh_lo: float = 0.0
    bg_thresh_hi: float = 0.5
    fg_thresh: float = 0.5
    ign_thresh: float = 0.5
    best_thresh: float = 0.35

    # --------------------------------------------------------------- inference
    nms_topN_pre: int = 3000
    nms_topN_post: int = 40
    nms_thres: float = 0.4
    clip_boxes: bool = False
    score_thres: float = 0.75
    # sparse pre-NMS compaction budget in anchors (0 = off): NMS runs only
    # over the anchors of positions whose best score clears score_thres
    # (inference/detect.py _compact_positions); exact for the rows the
    # result writer keeps
    nms_sparse_topm: int = 0
    # stop the sequential NMS selection once the best remaining score drops
    # below score_thres (ops/nms.py nms_select_t stop_below). Exact for every
    # detection the framework emits: its KITTI result writer drops
    # sub-threshold rows, and a sub-threshold box can never suppress a
    # higher-scoring one.
    nms_score_stop: bool = True
    # bitmask NMS over compacted candidates (ops/nms.py
    # nms_bitmask_select_t); engages only with nms_sparse_topm > 0
    nms_bitmask: bool = True

    test_protocol: str = "kitti"
    test_db: str = "kitti"

    eval_batch_size: int = 8
    eval_image_cache_mb: int = 512

    # ----------------------------------------------------------------- anchors
    cluster_anchors: int = 0
    even_anchors: int = 0
    expand_anchors: int = 0

    anchor_ratios: List[float] = field(default_factory=lambda: [0.5, 1.0, 1.5])
    num_anchor_scales: int = 12

    # runtime-injected (computed from the training imdb, cached with the run)
    anchors: Optional[np.ndarray] = None          # [A, 9]: x1,y1,x2,y2,z,w3,h3,l3,ry
    bbox_means: Optional[np.ndarray] = None       # [1, 11]
    bbox_stds: Optional[np.ndarray] = None        # [1, 11]

    # ------------------------------------------------------------------- loss
    hard_negatives: bool = True
    focal_loss: float = 0.0
    cls_2d_lambda: float = 1.0
    iou_2d_lambda: float = 1.0
    bbox_2d_lambda: float = 0.0
    bbox_3d_lambda: float = 1.0
    bbox_3d_proj_lambda: float = 0.0
    bbox_3d_iou_lambda: float = 0.0
    pre_compute_target: bool = True
    max_gts: int = 32

    hill_climbing: bool = True
    bins: int = 32

    pretrained: Optional[str] = None

    freeze_blacklist: Optional[List[str]] = None
    freeze_whitelist: Optional[List[str]] = None

    # ---------------------------------------------------------------- parallel
    dp_devices: int = -1
    mesh_spatial: int = 1
    mesh_model: int = 1

    # ------------------------------------------------------------- derived
    @property
    def min_gt_h(self) -> float:
        return self.test_scale[0] * self.percent_anc_h[0]

    @property
    def max_gt_h(self) -> float:
        return self.test_scale[0] * self.percent_anc_h[1]

    @property
    def anchor_scales(self) -> np.ndarray:
        """Geometric anchor height ladder."""
        n = self.num_anchor_scales
        base = (self.max_gt_h / self.min_gt_h) ** (1.0 / (n - 1))
        return np.array([self.min_gt_h * (base ** i) for i in range(n)])

    @property
    def num_classes(self) -> int:
        return len(self.lbls) + 1

    @property
    def feat_size(self) -> List[int]:
        return [int(np.ceil(s / self.feat_stride)) for s in self.crop_size]

    # ------------------------------------------------------------- (de)serialize
    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load(path: str) -> "Config":
        with open(path, "rb") as f:
            return pickle.load(f)


# ----------------------------------------------------------------------------
# Named configs mirroring the reference's three experiment files.
# ----------------------------------------------------------------------------

def kitti_3d_base(**kw) -> Config:
    """No attention, no alignment."""
    return Config(**kw)


def kitti_3d_anab(**kw) -> Config:
    """ANAB depth attention, lr 0.002."""
    cfg = Config(attention="ANAB", lr=0.002, lr_target=0.002 * 1e-5, eval_epoch=20)
    return cfg.replace(**kw) if kw else cfg


def kitti_3d_anab_fullalign(**kw) -> Config:
    """ANAB + shape/center align: the flagship detector."""
    cfg = Config(attention="ANAB", center_align=True, shape_align=True,
                 lr=0.002, lr_target=0.002 * 1e-5, eval_epoch=20)
    return cfg.replace(**kw) if kw else cfg


CONFIGS = {
    "kitti_3d_base": kitti_3d_base,
    "kitti_3d_anab": kitti_3d_anab,
    "kitti_3d_anab_fullalign": kitti_3d_anab_fullalign,
}


def load_config(name: str, **kw) -> Config:
    if name not in CONFIGS:
        raise KeyError(f"unknown config '{name}'; have {sorted(CONFIGS)}")
    return CONFIGS[name](**kw)


def flagship_conf(crop, num_scales: int = 12, backbone: str = "dla102",
                  dtype: str = "bfloat16") -> Config:
    """The flagship detector (`kitti_3d_anab_fullalign`) at input size
    `crop`, with synthetic anchors and whitening stats."""
    from .utils.synthetic_conf import finalize_conf_synthetic

    conf = kitti_3d_anab_fullalign().replace(
        crop_size=list(crop), test_scale=list(crop),
        num_anchor_scales=num_scales, back_bone=backbone, pre_train=False,
        compute_dtype=dtype)
    return finalize_conf_synthetic(conf)

"""Module grab-bag no config builds, kept for API-surface parity with the
reference package's `models/extras.py` (its re-derivation of the
upstream module collection): RetinaNet-style heads and anchor utilities,
weight-standardised convolution, a configurable conv-norm-activation
block, EfficientNet-style same-padding conv and Swish, and init helpers.

Names, argument conventions and layouts are the reference's: images NHWC
in and out, and module attribute names that `utils/weights.py` maps the
reference's parameter trees onto (`Conv_0`, `ConvWS_0`, `BatchNorm_0`,
`GroupNorm_0`). Where flax and torch differ, the reference's choice is
kept: GroupNorm's epsilon 1e-6, the population std in weight
standardisation, 'SAME' padding's extra row and column at the bottom and
right, BatchNorm with the momentum of `models/layers.py`. The random
initialisers take a `torch.Generator` and draw from the reference's
distributions (the two frameworks' random streams differ).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d, batch_norm


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _lecun_normal_(w: torch.Tensor, generator=None) -> torch.Tensor:
    """flax's lecun_normal: truncated normal in [-2, 2] std, variance
    1 / fan_in (an OIHW kernel's fan-in: I * kh * kw)."""
    std = math.sqrt(1.0 / w[0].numel()) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


def _conv(cin: int, features: int, kernel: int, stride: int = 1,
          padding: int = 0, bias: bool = True) -> Conv2d:
    """A conv with the reference's init: lecun-normal kernel, zero bias."""
    conv = Conv2d(cin, features, kernel, stride=stride, padding=padding,
                  bias=bias)
    with torch.no_grad():
        _lecun_normal_(conv.weight)
        if bias:
            conv.bias.zero_()
    return conv


# ---------------------------------------------------------------------------
# RetinaNet-style box utilities
# ---------------------------------------------------------------------------

def bbox_transform_retina(boxes, deltas, mean=(0.0, 0.0, 0.0, 0.0),
                          std=(0.1, 0.1, 0.2, 0.2)):
    """Decode center/size deltas against anchor boxes [..., 4] xyxy."""
    boxes = torch.as_tensor(boxes)
    deltas = torch.as_tensor(deltas)
    mean = torch.as_tensor(mean, dtype=boxes.dtype)
    std = torch.as_tensor(std, dtype=boxes.dtype)
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights
    dx = deltas[..., 0] * std[0] + mean[0]
    dy = deltas[..., 1] * std[1] + mean[1]
    dw = deltas[..., 2] * std[2] + mean[2]
    dh = deltas[..., 3] * std[3] + mean[3]
    pred_ctr_x = ctr_x + dx * widths
    pred_ctr_y = ctr_y + dy * heights
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    return torch.stack([pred_ctr_x - 0.5 * pred_w, pred_ctr_y - 0.5 * pred_h,
                        pred_ctr_x + 0.5 * pred_w, pred_ctr_y + 0.5 * pred_h],
                       dim=-1)


def clip_boxes(boxes, im_h: int, im_w: int):
    """Clamp xyxy boxes to the image."""
    return torch.stack([torch.clamp(boxes[..., 0], 0, im_w),
                        torch.clamp(boxes[..., 1], 0, im_h),
                        torch.clamp(boxes[..., 2], 0, im_w),
                        torch.clamp(boxes[..., 3], 0, im_h)], dim=-1)


class RetinaRegressionHead(nn.Module):
    """4 conv + ReLU tower -> num_anchors*4 regression map, flattened to
    [B, H*W*A, 4]. x [B, H, W, cin]."""

    def __init__(self, cin: int, num_anchors: int = 9,
                 feature_size: int = 256):
        super().__init__()
        self.num_anchors = num_anchors
        for i in range(4):
            self.add_module(f"Conv_{i}", _conv(cin if i == 0 else feature_size,
                                               feature_size, 3, padding=1))
        self.Conv_4 = _conv(feature_size, num_anchors * 4, 3, padding=1)

    def forward(self, x):
        x = _nchw(x)
        for i in range(4):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        x = _nhwc(self.Conv_4(x))
        B, H, W, _ = x.shape
        return x.reshape(B, H * W * self.num_anchors, 4)


class RetinaClassificationHead(nn.Module):
    """4 conv + ReLU tower -> per-anchor class sigmoids, flattened to
    [B, H*W*A, C]; the last bias starts at the prior's logit, so the first
    P(fg) is `prior`."""

    def __init__(self, cin: int, num_anchors: int = 9, num_classes: int = 80,
                 prior: float = 0.01, feature_size: int = 256):
        super().__init__()
        self.num_anchors, self.num_classes = num_anchors, num_classes
        for i in range(4):
            self.add_module(f"Conv_{i}", _conv(cin if i == 0 else feature_size,
                                               feature_size, 3, padding=1))
        self.Conv_4 = _conv(feature_size, num_anchors * num_classes, 3,
                            padding=1)
        with torch.no_grad():
            self.Conv_4.bias.fill_(bias_init_with_prob(prior))

    def forward(self, x):
        x = _nchw(x)
        for i in range(4):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        x = _nhwc(torch.sigmoid(self.Conv_4(x)))
        B, H, W, _ = x.shape
        return x.reshape(B, H * W * self.num_anchors, self.num_classes)


# ------------------------------------------------------- pyramid anchors

def retina_generate_anchors(base_size=16, ratios=None, scales=None):
    """Base anchor templates [A, 4] centred at the origin."""
    if ratios is None:
        ratios = np.array([0.5, 1.0, 2.0])
    if scales is None:
        scales = np.array([2 ** 0, 2 ** (1.0 / 3.0), 2 ** (2.0 / 3.0)])
    num = len(ratios) * len(scales)
    anchors = np.zeros((num, 4))
    anchors[:, 2:] = base_size * np.tile(scales, (2, len(ratios))).T
    areas = anchors[:, 2] * anchors[:, 3]
    anchors[:, 2] = np.sqrt(areas / np.repeat(ratios, len(scales)))
    anchors[:, 3] = anchors[:, 2] * np.repeat(ratios, len(scales))
    anchors[:, 0::2] -= np.tile(anchors[:, 2] * 0.5, (2, 1)).T
    anchors[:, 1::2] -= np.tile(anchors[:, 3] * 0.5, (2, 1)).T
    return anchors


def shift_anchors(shape: Tuple[int, int], stride: int, anchors: np.ndarray):
    """Tile base anchors over a feature grid: [H*W*A, 4]."""
    shift_x = (np.arange(0, shape[1]) + 0.5) * stride
    shift_y = (np.arange(0, shape[0]) + 0.5) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    A = anchors.shape[0]
    K = shifts.shape[0]
    out = anchors.reshape(1, A, 4) + shifts.reshape(1, K, 4).transpose(1, 0, 2)
    return out.reshape(K * A, 4)


def anchors_for_shape(image_shape, pyramid_levels=(3, 4, 5, 6, 7),
                      ratios=None, scales=None):
    """Every anchor of an image over the FPN levels."""
    image_shape = np.array(image_shape[:2])
    all_anchors = []
    for lvl in pyramid_levels:
        stride = 2 ** lvl
        shape = (image_shape + stride - 1) // stride
        a = retina_generate_anchors(base_size=2 ** (lvl + 2), ratios=ratios,
                                    scales=scales)
        all_anchors.append(shift_anchors(tuple(shape), stride, a))
    return np.concatenate(all_anchors, axis=0)


# ---------------------------------------------------------------------------
# Weight-standardised conv and ConvModule
# ---------------------------------------------------------------------------

class ConvWS(nn.Module):
    """Conv whose kernel is whitened over (kh, kw, cin) per output channel
    (mean 0, population std + eps) before the convolution; 'same' padding
    k // 2. x NCHW."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, use_bias: bool = True, eps: float = 1e-5):
        super().__init__()
        self.stride, self.pad, self.eps = stride, kernel // 2, eps
        self.weight = nn.Parameter(_lecun_normal_(
            torch.empty(features, cin, kernel, kernel)))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x):
        w = self.weight
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        std = w.std(dim=(1, 2, 3), keepdim=True, unbiased=False) + self.eps
        w = ((w - mean) / std).to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, w, b, self.stride, self.pad)


class ConvModule(nn.Module):
    """Configurable conv-norm-activation block: conv type ('conv' |
    'conv_ws'), norm ('bn' | 'gn' | None), activation ('relu' | 'leaky' |
    None), in any `order`. x [B, H, W, cin] -> NHWC. A norm before the
    conv normalises the input's `cin` channels."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, conv_type: str = "conv",
                 norm: Optional[str] = "bn", act: Optional[str] = "relu",
                 gn_groups: int = 32,
                 order: Sequence[str] = ("conv", "norm", "act")):
        super().__init__()
        self.order, self.norm, self.act = tuple(order), norm, act
        bias = norm is None
        if conv_type == "conv_ws":
            self.conv_name = "ConvWS_0"
            self.ConvWS_0 = ConvWS(cin, features, kernel, stride,
                                   use_bias=bias)
        else:
            self.conv_name = "Conv_0"
            self.Conv_0 = _conv(cin, features, kernel, stride, kernel // 2,
                                bias=bias)
        ch = cin if self.order.index("norm") < self.order.index("conv") \
            else features
        if norm == "bn":
            self.BatchNorm_0 = batch_norm(ch)
        elif norm == "gn":
            self.GroupNorm_0 = nn.GroupNorm(gn_groups, ch, eps=1e-6)

    def forward(self, x, train: bool = True):
        x = _nchw(x)
        for name in self.order:
            if name == "conv":
                x = getattr(self, self.conv_name)(x)
            elif name == "norm" and self.norm == "bn":
                self.BatchNorm_0.train(train)
                x = self.BatchNorm_0(x)
            elif name == "norm" and self.norm == "gn":
                x = self.GroupNorm_0(x)
            elif name == "act" and self.act == "relu":
                x = F.relu(x)
            elif name == "act" and self.act == "leaky":
                x = F.leaky_relu(x, 0.01)
        return _nhwc(x)


# ---------------------------------------------------------------------------
# EfficientNet helpers
# ---------------------------------------------------------------------------

def swish(x):
    """x * sigmoid(x)."""
    return x * torch.sigmoid(x)


class Conv2dSamePadding(nn.Module):
    """TensorFlow-style 'SAME' conv: output ceil(in / stride), the odd
    padding row and column at the bottom and right. x NHWC."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, use_bias: bool = True):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.Conv_0 = _conv(cin, features, kernel, stride, 0, bias=use_bias)

    def _pads(self, n: int) -> Tuple[int, int]:
        out = -(-n // self.stride)
        total = max((out - 1) * self.stride + self.kernel - n, 0)
        return total // 2, total - total // 2

    def forward(self, x):
        x = _nchw(x)
        top, bottom = self._pads(x.shape[2])
        left, right = self._pads(x.shape[3])
        return _nhwc(self.Conv_0(F.pad(x, (left, right, top, bottom))))


def drop_connect(x, rng: torch.Generator, rate: float, deterministic: bool):
    """Per-sample stochastic depth: each sample kept with probability
    1 - rate (drawn from `rng`) and scaled by 1 / (1 - rate)."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    u = torch.rand(shape, generator=rng, device=x.device)
    return x * (u < keep).to(x.dtype) / keep


def round_filters(filters: int, width_coefficient: Optional[float],
                  depth_divisor: int = 8, min_depth: Optional[int] = None):
    """EfficientNet channel scaling."""
    if not width_coefficient:
        return filters
    filters *= width_coefficient
    min_depth = min_depth or depth_divisor
    new_filters = max(min_depth,
                      int(filters + depth_divisor / 2)
                      // depth_divisor * depth_divisor)
    if new_filters < 0.9 * filters:
        new_filters += depth_divisor
    return int(new_filters)


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------

def bias_init_with_prob(prior_prob: float) -> float:
    """The bias whose sigmoid is prior_prob."""
    return float(-math.log((1 - prior_prob) / prior_prob))


def _fans(shape) -> Tuple[int, int]:
    """(fan_in, fan_out) of an HWIO conv or [in, out] dense shape, by the
    reference's rule."""
    fan_in = int(np.prod(shape[:-1]))
    fan_out = int(shape[-1]) * (int(np.prod(shape[:-2])) if len(shape) > 2
                                else 1)
    return fan_in, fan_out


def xavier_init(rng: torch.Generator, shape, gain: float = 1.0,
                distribution: str = "normal"):
    """Xavier/Glorot init of an HWIO conv or [in, out] dense shape."""
    fan_in, fan_out = _fans(shape)
    if distribution == "uniform":
        a = gain * math.sqrt(6.0 / (fan_in + fan_out))
        return torch.empty(tuple(shape)).uniform_(-a, a, generator=rng)
    std = gain * math.sqrt(2.0 / (fan_in + fan_out))
    return torch.randn(tuple(shape), generator=rng) * std


def kaiming_init(rng: torch.Generator, shape, a: float = 0.0,
                 mode: str = "fan_out", distribution: str = "normal"):
    """He init of an HWIO conv or [in, out] dense shape."""
    fan_in, fan_out = _fans(shape)
    fan = fan_out if mode == "fan_out" else fan_in
    gain = math.sqrt(2.0 / (1 + a ** 2))
    if distribution == "uniform":
        bound = gain * math.sqrt(3.0 / fan)
        return torch.empty(tuple(shape)).uniform_(-bound, bound,
                                                  generator=rng)
    return torch.randn(tuple(shape), generator=rng) * (gain / math.sqrt(fan))

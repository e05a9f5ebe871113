"""Plain PyTorch forward of the M3DSSD detector (DLA backbone, DLAUp/IDAUp
neck with deformable convolutions, 13 towers, shape and center alignment,
ANAB), written from the published description as a frozen yardstick.

It imports nothing of the program. Weights come by name from a `Params`
store; one forward on `meta` tensors with a recording store lists every
weight the model has (name, shape, kind, fan-in), from which the benchmark
makes the weights that both sides load. Tensors are NCHW; heads follow the
(h, w, a) anchor order of the published anchors. Alignment and the neck's
deformable layers run in their dense form: the offsets a sparse path would
take at confident positions are the dense form's offsets there.

`Ref(cfg, params, quant)`: `quant` (default identity) is applied to both
operands of every convolution and product, which is how the control runs
the same arithmetic in a lower precision (`reference/quant.py`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
SLOPE = 0.01
PSP_SIZES = (1, 4, 8, 16)
REG_TOWERS = ("bbox_x", "bbox_y", "bbox_w", "bbox_h", "bbox_x3d",
              "bbox_y3d", "bbox_z3d", "bbox_w3d", "bbox_h3d", "bbox_l3d",
              "bbox_rY3d")

# levels, channels, block and residual root of each DLA variant
DLA = {
    "dla34": ([1, 1, 1, 2, 2, 1], [16, 32, 64, 128, 256, 512], "basic",
              False),
    "dla102": ([1, 1, 1, 3, 4, 1], [16, 32, 128, 256, 512, 1024],
               "bottleneck", True),
}


class Params:
    """Weights by name. With `record`, a name is created on first use as
    zeros on the input's device (free on `meta`) and `spec[name]` keeps
    (shape, kind, fan_in)."""

    def __init__(self, tensors: Optional[Dict[str, torch.Tensor]] = None,
                 record: bool = False):
        self.tensors = tensors or {}
        self.spec = {} if record else None

    def __call__(self, name, shape, kind, like, fan_in=None):
        shape = tuple(int(s) for s in shape)
        if self.spec is not None:
            self.spec[name] = (shape, kind, fan_in)
            dtype = torch.int64 if kind == "bn_count" else like.dtype
            return torch.zeros(shape, dtype=dtype, device=like.device)
        t = self.tensors[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
        return t


def leaky(x):
    return F.leaky_relu(x, SLOPE)


def bilinear_sample(x, py, px):
    """x [B,H,W,C] sampled at (py, px) [B, *S] with per-corner zero
    padding: [B, *S, C]."""
    B, H, W, C = x.shape
    sshape = tuple(py.shape[1:])
    n = math.prod(sshape)
    py, px = py.reshape(B, n), px.reshape(B, n)
    y0, x0 = torch.floor(py), torch.floor(px)
    ly, lx = py - y0, px - x0
    y0i, x0i = y0.long(), x0.long()
    flat = x.reshape(B * H * W, C)
    base = (torch.arange(B, device=x.device) * (H * W))[:, None]
    out = torch.zeros((B, n, C), dtype=x.dtype, device=x.device)
    for dy, wy in ((0, 1.0 - ly), (1, ly)):
        yy = y0i + dy
        for dx, wx in ((0, 1.0 - lx), (1, lx)):
            xx = x0i + dx
            inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            idx = yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1) + base
            v = flat.index_select(0, idx.reshape(-1)).reshape(B, n, C)
            out = out + v * (wy * wx * inside)[..., None]
    return out.reshape((B,) + sshape + (C,))


class Ref:
    """The detector's forward at the configuration `cfg` (the `model`
    group of a configuration file)."""

    def __init__(self, cfg: dict, params: Params,
                 quant: Optional[Callable] = None, anchors=None, means=None,
                 stds=None):
        self.cfg = cfg
        self.p = params
        self.q = quant or (lambda t: t)
        self.anchors = anchors
        self.means = means
        self.stds = stds
        self.dcn_shapes: List[tuple] = []   # (B, H, W, Cin, Cout) per neck DCN
        # called with a stage's name where it begins ("backbone", "neck",
        # "head", "align", "anab"), for counts by stage
        self.on_stage: Callable[[str], None] = lambda name: None
        # set by yardstick/weights.py:calibrate for its passes: the neck's
        # offset convolutions, the regression towers' last convolutions and
        # the class logits are set to what this forward's data needs
        self.calibration = None
        # operations of the convolutions and products run so far (2 per
        # multiply-add, as torch.utils.flop_counter counts them)
        self.flops = 0

    # -- layers ------------------------------------------------------------
    def conv(self, x, name, cout, k, stride=1, bias=True):
        cin = x.shape[1]
        w = self.p(f"{name}.weight", (cout, cin, k, k), "conv_w", x,
                   fan_in=cin * k * k)
        b = self.p(f"{name}.bias", (cout,), "conv_b", x) if bias else None
        y = self.q(F.conv2d(self.q(x), self.q(w), b, stride, (k - 1) // 2))
        self.flops += 2 * y.numel() * cin * k * k
        return y

    def bn(self, x, name):
        c = x.shape[1]
        w = self.p(f"{name}.weight", (c,), "bn_w", x)
        b = self.p(f"{name}.bias", (c,), "bn_b", x)
        m = self.p(f"{name}.running_mean", (c,), "bn_mean", x)
        v = self.p(f"{name}.running_var", (c,), "bn_var", x)
        if self.p.spec is not None:
            self.p(f"{name}.num_batches_tracked", (), "bn_count", x)
        return self.q(F.batch_norm(x, m, v, w, b, False, 0.0, BN_EPS))

    def conv_bn(self, x, name, cout, k, stride=1, act=True, bias=False,
                conv="Conv_0", norm="BatchNorm_0"):
        y = self.bn(self.conv(x, f"{name}.{conv}", cout, k, stride, bias),
                    f"{name}.{norm}")
        return self.act(y) if act else y

    def act(self, x):
        return self.q(leaky(x))

    def dcn(self, x, name, offset, mask, k, pad, cout=None, kind="dcn_w"):
        """Modulated deformable conv: x [B,C,H,W], offset [B,H,W,KK,2]
        (dy, dx), mask [B,H,W,KK] -> [B,Cout,H,W]."""
        B, C, H, W = x.shape
        cout = cout or C
        KK = k * k
        w = self.p(f"{name}.weight", (k, k, C, cout), kind, x,
                   fan_in=KK * C)
        b = self.p(f"{name}.bias", (cout,), kind.replace("_w", "_b"), x)
        dev = x.device
        ys = torch.arange(H, dtype=x.dtype, device=dev) - pad
        xs = torch.arange(W, dtype=x.dtype, device=dev) - pad
        tap = torch.arange(k, dtype=x.dtype, device=dev)
        py = (ys[None, :, None, None] + tap.repeat_interleave(k)
              + offset[..., 0])
        px = (xs[None, None, :, None] + tap.repeat(k) + offset[..., 1])
        xh = x.permute(0, 2, 3, 1).contiguous()
        cols = bilinear_sample(xh, py, px) * mask[..., None]
        out = self.q(cols.reshape(B * H * W, KK * C)) @ self.q(
            w.reshape(KK * C, cout))
        self.flops += 2 * B * H * W * KK * C * cout
        return self.q(out + b).reshape(B, H, W, cout).permute(0, 3, 1, 2)

    # -- backbone ------------------------------------------------------------
    def block(self, x, name, planes, stride, residual):
        if self.kind == "basic":
            y = self.conv_bn(x, f"{name}.ConvBNAct_0", planes, 3, stride,
                             bias=True)
            y = self.conv_bn(y, f"{name}.ConvBNAct_1", planes, 3, act=False,
                             bias=True)
        else:
            bottle = planes // 2
            y = self.conv_bn(x, f"{name}.ConvBNAct_0", bottle, 1)
            y = self.conv_bn(y, name, bottle, 3, stride)
            y = self.conv_bn(y, f"{name}.ConvBNAct_1", planes, 1, act=False)
        return self.act(y + residual)

    def tree(self, x, name, levels, cout, stride, level_root,
             children=None):
        children = [] if children is None else list(children)
        bottom = F.max_pool2d(x, stride, stride) if stride > 1 else x
        residual = bottom
        if x.shape[1] != cout:
            residual = self.conv_bn(bottom, f"{name}.project", cout, 1,
                                    act=False)
        if level_root:
            children.append(bottom)
        if levels == 1:
            x1 = self.block(x, f"{name}.tree1", cout, stride, residual)
            x2 = self.block(x1, f"{name}.tree2", cout, 1, x1)
            kids = [x2, x1] + children
            y = self.bn(self.conv(torch.cat(kids, 1), f"{name}.root.Conv_0",
                                  cout, 1, bias=False),
                        f"{name}.root.BatchNorm_0")
            return self.act(y + kids[0] if self.root_residual else y)
        x1 = self.tree(x, f"{name}.tree1", levels - 1, cout, stride, False)
        children.append(x1)
        return self.tree(x1, f"{name}.tree2", levels - 1, cout, 1, False,
                         children)

    def dla(self, x):
        self.on_stage("backbone")
        levels, ch, self.kind, self.root_residual = DLA[self.cfg["backbone"]]
        pre = "base.base"
        x = self.conv_bn(x, pre, ch[0], 7, conv="base_conv", norm="base_bn")
        x = self.conv_bn(x, f"{pre}.ConvBNAct_0", ch[0], 3)
        out = [x]
        x = self.conv_bn(x, f"{pre}.ConvBNAct_1", ch[1], 3, 2)
        out.append(x)
        for i in range(4):
            x = self.tree(x, f"{pre}.Tree_{i}", levels[i + 2], ch[i + 2], 2,
                          i > 0)
            out.append(x)
        return out, ch

    # -- neck ----------------------------------------------------------------
    def deform_conv(self, x, name, cout):
        """DCN (3x3, learned offsets clipped to +-clamp) -> BN -> LReLU."""
        B, C, H, W = x.shape
        if self.calibration is not None:
            self.calibration.offsets(self, x, f"{name}.DCN_0.conv_offset_mask")
        om = self.conv(x, f"{name}.DCN_0.conv_offset_mask", 27, 3)
        om = om.permute(0, 2, 3, 1)
        clamp = float(self.cfg["dcn_shift_clamp"])
        offset = torch.stack([om[..., :9], om[..., 9:18]], -1).clamp(
            -clamp, clamp)
        self.dcn_shapes.append((B, H, W, C, cout))
        y = self.dcn(x, f"{name}.DCN_0", offset, torch.sigmoid(om[..., 18:]),
                     3, 1, cout)
        return self.act(self.bn(y, f"{name}.BatchNorm_0"))

    def upsample(self, x, name, f):
        C = x.shape[1]
        w = self.p(f"{name}.weight", (C, 1, 2 * f, 2 * f), "up_w", x)
        self.flops += 2 * x.numel() * 4 * f * f
        return self.q(F.conv_transpose2d(self.q(x), self.q(w), None, f,
                                         f // 2, groups=C))

    def ida_up(self, layers, name, out_ch, factors, start, end):
        layers = list(layers)
        for i in range(start + 1, end):
            j = i - start - 1
            y = self.deform_conv(layers[i], f"{name}.projs_{j}", out_ch)
            y = self.upsample(y, f"{name}.ups_{j}", factors[j + 1])
            layers[i] = self.deform_conv(y + layers[i - 1],
                                         f"{name}.nodes_{j}", out_ch)
        return layers

    def dla_seg(self, images):
        levels, ch = self.dla(images)
        self.on_stage("neck")
        first = int(np.log2(self.cfg["feat_stride"]))
        ch = ch[first:]
        layers = levels[first:]
        scales = [2 ** i for i in range(len(ch))]
        out = [layers[-1]]
        for i in range(len(ch) - 1):
            j = -i - 2
            factors = [s // scales[j] for s in scales[j:]]
            start = len(layers) - i - 2
            layers = self.ida_up(layers, f"base.dla_up.idas_{i}", ch[j],
                                 factors, start, len(layers))
            out.insert(0, layers[-1])
            scales[j + 1:] = [scales[j]] * len(scales[j + 1:])
        n_final = 5 - first
        y = self.ida_up(out[:n_final], "base.ida_up", ch[0],
                        [2 ** i for i in range(n_final)], 0, n_final)
        return y[-1]

    # -- head ----------------------------------------------------------------
    def tower(self, x, name, cout, k=1):
        hidden = int(self.cfg["head_hidden"])
        y = self.conv_bn(x, name, hidden, k, bias=True)
        y = self.conv_bn(y, name, hidden, 1, bias=True, conv="Conv_1",
                         norm="BatchNorm_1")
        if self.calibration is not None:
            self.calibration.last_conv(self, y, f"{name}.Conv_2", cout)
        return self.conv(y, f"{name}.Conv_2", cout, 1)

    def shape_align(self, x, conf_max, conf_ind):
        """3x3 deformable taps spread over the most confident anchor's
        size, where that confidence passes the threshold; residual."""
        B, C, H, W = x.shape
        K, stride = 3, self.cfg["feat_stride"]
        a = torch.as_tensor(self.anchors, dtype=x.dtype, device=x.device)
        h_step = (a[:, 3] - a[:, 1]) / stride / K
        w_step = (a[:, 2] - a[:, 0]) / stride / K
        i = torch.arange(K, dtype=x.dtype, device=x.device) - K / 2 + 0.5
        table = torch.stack([
            (h_step[:, None, None] - 1) * i[None, :, None].expand(-1, K, K),
            (w_step[:, None, None] - 1) * i[None, None, :].expand(-1, K, K)],
            -1).reshape(-1, K * K, 2)
        hard = (conf_max > float(self.cfg["align_thresh"])).to(x.dtype)
        offset = table[conf_ind] * hard[..., None, None]
        mask = conf_max[..., None].expand(B, H, W, K * K)
        self.on_stage("align")
        y = self.dcn(x, "shape_align_mod", offset, mask, K, 1, C,
                     kind="align_w") + x
        self.on_stage("head")
        return y

    def center_align(self, x, name, bx, by, conf_max, conf_ind, slot):
        """1x1 deformable tap moved by the most confident anchor's
        un-whitened center regression; residual."""
        B, C, H, W = x.shape
        stride = self.cfg["feat_stride"]
        a = torch.as_tensor(self.anchors, dtype=x.dtype, device=x.device)
        aw = (a[:, 2] - a[:, 0]) / stride
        ah = (a[:, 3] - a[:, 1]) / stride
        mean = torch.as_tensor(self.means[slot:slot + 2], dtype=x.dtype,
                               device=x.device)
        std = torch.as_tensor(self.stds[slot:slot + 2], dtype=x.dtype,
                              device=x.device)
        ind = conf_ind[..., None]
        bx = bx.permute(0, 2, 3, 1).gather(-1, ind)[..., 0]
        by = by.permute(0, 2, 3, 1).gather(-1, ind)[..., 0]
        off_x = (bx * std[0] + mean[0]) * aw[conf_ind]
        off_y = (by * std[1] + mean[1]) * ah[conf_ind]
        hard = (conf_max > float(self.cfg["align_thresh"])).to(x.dtype)
        offset = (torch.stack([off_y, off_x], -1) * hard[..., None])[
            :, :, :, None, :]
        self.on_stage("align")
        y = self.dcn(x, name, offset, conf_max[..., None], 1, 0, C,
                     kind="align_w") + x
        self.on_stage("head")
        return y

    def anab(self, x):
        B, C, H, W = x.shape
        key_ch = sum(s * s for s in PSP_SIZES) // 2
        query = self.conv(x, "anab.query_conv", key_ch, 1, bias=False)
        query = query.permute(0, 2, 3, 1).reshape(B, H * W, key_ch)
        atten = torch.sigmoid(self.conv(x, "anab.spatial_conv",
                                        len(PSP_SIZES), 1, bias=False))

        def pool(f):
            return torch.cat([
                F.adaptive_avg_pool2d(f * atten[:, i:i + 1], s).flatten(2)
                .transpose(1, 2) for i, s in enumerate(PSP_SIZES)], 1)

        key = pool(self.conv(x, "anab.key_conv", key_ch, 1, bias=False))
        value = pool(self.conv(x, "anab.value_conv", C, 1, bias=False))
        att = torch.softmax(self.q(query) @ self.q(key).transpose(1, 2), -1)
        out = self.q(att) @ self.q(value)
        self.flops += 2 * B * H * W * key.shape[1] * (key_ch + C)
        return out.reshape(B, H, W, C).permute(0, 3, 1, 2) + x

    def forward(self, images):
        """images [B, H, W, 3] (NHWC, preprocessed) -> dict of cls [B,N,NC]
        logits, scores [B,N] (best foreground probability), cls_pred [B,N]
        (its class, 1..NC-1), bbox_2d [B,4,N], bbox_3d [B,7,N]."""
        return self.head(self.features(images))

    def features(self, images):
        """The backbone's and neck's features [B, C, H, W] of images
        [B, H, W, 3]."""
        self.dcn_shapes = []
        return self.dla_seg(images.permute(0, 3, 1, 2))

    def head(self, x):
        """The towers, alignment, ANAB and flattening of `forward` from the
        neck's features x [B, C, H, W]."""
        cfg = self.cfg
        B, C, H, W = x.shape
        A = len(self.anchors)
        NC = len(cfg["lbls"]) + 1
        self.on_stage("head")
        cls = self.tower(x, "cls_tower", A * NC, 3)
        cls = cls.permute(0, 2, 3, 1).reshape(B, H, W, A, NC)
        if self.calibration is not None:
            cls = self.calibration.classes(self, cls)
        prob = torch.softmax(cls, -1)
        fg = prob[..., 1:]
        scores, cls_pred = fg.max(-1)
        conf_max, conf_ind = (1.0 - prob[..., 0]).max(-1)

        def head(name, feats):
            return self.tower(feats, name, A)

        feats = x
        if cfg["shape_align"]:
            feats = self.shape_align(x, conf_max, conf_ind)
        t = {n: None for n in REG_TOWERS}
        t["bbox_x"], t["bbox_y"] = head("bbox_x", feats), head("bbox_y", feats)
        f2d = feats
        if cfg["center_align"]:
            f2d = self.center_align(feats, "center_align2d", t["bbox_x"],
                                    t["bbox_y"], conf_max, conf_ind, 0)
        t["bbox_w"], t["bbox_h"] = head("bbox_w", f2d), head("bbox_h", f2d)
        t["bbox_x3d"] = head("bbox_x3d", feats)
        t["bbox_y3d"] = head("bbox_y3d", feats)
        f3d = feats
        if cfg["center_align"]:
            f3d = self.center_align(feats, "center_align3d", t["bbox_x3d"],
                                    t["bbox_y3d"], conf_max, conf_ind, 4)
        for n in ("bbox_w3d", "bbox_h3d", "bbox_l3d", "bbox_rY3d"):
            t[n] = head(n, f3d)
        fz = f3d
        if cfg["attention"] == "ANAB":
            self.on_stage("anab")
            fz = self.act(self.bn(self.anab(f3d), "anab_bn"))
            self.on_stage("head")
        t["bbox_z3d"] = head("bbox_z3d", fz)

        def flat(v):                             # [B,A,H,W] -> [B,H*W*A]
            return v.permute(0, 2, 3, 1).reshape(B, -1)

        return {
            "cls": cls.reshape(B, H * W * A, NC),
            "scores": scores.reshape(B, -1),
            "cls_pred": (cls_pred + 1).reshape(B, -1),
            "bbox_2d": torch.stack([flat(t[n]) for n in REG_TOWERS[:4]], 1),
            "bbox_3d": torch.stack([flat(t[n]) for n in (
                "bbox_x3d", "bbox_y3d", "bbox_z3d", "bbox_w3d", "bbox_h3d",
                "bbox_l3d", "bbox_rY3d")], 1),
        }


def upsample_kernel(f: int, channels: int) -> torch.Tensor:
    """Depthwise transposed-conv weight [C, 1, 2f, 2f] of bilinear
    interpolation by f."""
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    r = torch.arange(2 * f, dtype=torch.float64)
    w1 = 1 - torch.abs(r / f - c)
    return (w1[:, None] * w1[None, :]).float()[None, None].repeat(
        channels, 1, 1, 1)


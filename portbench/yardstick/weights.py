"""The weights both sides load, made on the device from the run's seed.

Every weight of the reference's list (`reference/model.py:weight_spec`) is
drawn in one normal draw of a `torch.Generator` on the device, clipped at 2
deviations and scaled per tensor in two more calls:

* convolutions: variance 1/fan-in (LeCun), zero bias;
* deformable and alignment weights: variance 1/(3 fan-in), zero bias;
* the neck's offset/mask convolutions: biases of 0.3, and weights scaled
  by `calibrate` so that offsets (before the bias) have a deviation of
  `offset_std` pixels: fractional, some past the clamp, as a trained
  neck's;
* BatchNorm the identity; upsampling the bilinear kernel;
* the regression towers' last convolutions scaled by `calibrate` to
  deltas of deviation `delta_std`, as a trained detector's whitened ones;
* the classification tower's last convolution made orthogonal to its
  input's mean and mixed over the anchors, so that like boxes score alike,
  and its spread and the foreground classes' biases set by `calibrate` so
  that each image holds about `detections_per_image` detections after
  NMS, as many as a KITTI frame holds objects.

Values are rounded to the served type once; the reference takes the same
rounded values in float32.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..reference import decode as rdecode
from ..reference.anchors import locate_anchors
from ..reference.model import Params, Ref, upsample_kernel

CLIP = 2.0
# the foreground shift is bisected in [-SHIFT, SHIFT] logits
SHIFT, SHIFT_STEPS = 100.0, 24


def _std(name: str, kind: str, fan_in) -> float:
    if kind == "conv_w":
        return 1.0 / math.sqrt(fan_in)
    if kind == "conv_b" and "conv_offset_mask" in name:
        return 0.3
    if kind in ("dcn_w", "align_w"):
        return 1.0 / math.sqrt(3.0 * fan_in)
    return 0.0


def make_weights(spec: dict, seed: int, device, dtype=torch.bfloat16
                 ) -> Dict[str, torch.Tensor]:
    """{name: tensor} in `dtype` (BatchNorm counts int64) for `spec`."""
    drawn = [(n, s, _std(n, k, f)) for n, (s, k, f) in spec.items()
             if _std(n, k, f) > 0.0]
    sizes = [math.prod(s) for _, s, _ in drawn]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    stds = torch.tensor([sd for _, _, sd in drawn], device=device)
    flat = flat.clamp_(-CLIP, CLIP).mul_(torch.repeat_interleave(
        stds, torch.tensor(sizes, device=device))).to(dtype)
    out = {}
    for (name, shape, _), part in zip(drawn, flat.split(sizes)):
        out[name] = part.view(shape)
    for name, (shape, kind, _) in spec.items():
        if name in out:
            continue
        if kind == "bn_count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
        elif kind in ("bn_w", "bn_var"):
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        elif kind == "up_w":
            out[name] = upsample_kernel(shape[2] // 2, shape[0]).to(
                device, dtype)
        else:
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
    return out


class Calibration:
    """What `calibrate`'s passes of the reference set from their data.
    Weights it fits are rounded to the served type `dtype` before they are
    used further, so that the passes see what both sides will load."""

    def __init__(self, dtype, offset_std: float, delta_std: float,
                 anchor_iou_power: float, logit_std: float, car_lead: float):
        self.dtype = dtype
        self.offset_std = offset_std
        self.delta_std = delta_std
        self.anchor_iou_power = anchor_iou_power
        self.logit_std = logit_std
        self.car_lead = car_lead
        self.fitted = set()
        # the foreground logits' shift under trial; None until `classes`
        # has fitted the logits' scale
        self.shift = None

    def served(self, t):
        return t.to(self.dtype).float()

    def offsets(self, ref, x, name):
        """Scale the offset/mask convolution `name` so that its output,
        less its bias, has deviation `offset_std` on this input."""
        w = ref.p(f"{name}.weight", (27, x.shape[1], 3, 3), "conv_w", x)
        y = torch.nn.functional.conv2d(x, w, None, 1, 1)
        w.copy_(self.served(w * (self.offset_std
                                 / y.std().clamp(min=1e-12))))

    def last_conv(self, ref, y, name, cout):
        """Fit a tower's last convolution `name` on its input y, once.
        A regression tower's is scaled so that its output has deviation
        `delta_std`: a trained detector's whitened deltas have about unit
        deviation. The classification tower's rows are made orthogonal to
        y's mean, so that no anchor's logit is high everywhere (a trained
        tower's normalised features have no such offset, and a bias that
        took it away would be too large to serve), and mixed over the
        anchors (`anchor_mixing`), so that anchors of like boxes score
        alike and a confident place holds a cluster of overlapping
        candidates, as a trained detector's object does."""
        if name in self.fitted:
            return
        self.fitted.add(name)
        w = ref.p(f"{name}.weight", (cout, y.shape[1], 1, 1), "conv_w", y)
        if not name.startswith("cls_tower."):
            out = torch.nn.functional.conv2d(y, w)
            w.copy_(self.served(w * (self.delta_std
                                     / out.std().clamp(min=1e-12))))
            return
        A = len(ref.anchors)
        rows = w.view(A, cout // A, -1)
        mean = y.mean((0, 2, 3))
        mean = mean / mean.norm().clamp(min=1e-12)
        rows -= (rows @ mean)[..., None] * mean
        mix = anchor_mixing(ref.anchors, self.anchor_iou_power).to(w)
        rows.copy_(torch.einsum("ab,bcn->acn", mix, rows))

    def classes(self, ref, cls):
        """On the first call, scale the classification tower's last
        convolution so that its logits (less the bias) have deviation
        `logit_std` (by their median absolute deviation), as a trained
        classifier's clear margins, and raise the Car bias by `car_lead`
        over the other foreground classes (random classes move together,
        so otherwise none would reach the score threshold alone). Every
        call adds the foreground shift under trial to the biases, as they
        will be served. Returns the logits."""
        A, NC = cls.shape[-2], cls.shape[-1]
        w, b = self._last_conv(ref, A, NC, cls)
        fg = torch.ones(NC, device=cls.device)
        fg[0] = 0.0
        if self.shift is None:
            raw = cls - b
            # a robust deviation: a few positions' logits are far out
            mad = (raw - raw.median()).abs().median() * 1.4826
            scale = self.logit_std / mad.clamp(min=1e-12)
            w.copy_(self.served(w * scale))
            b[:, 1] += self.car_lead
            self.shift = 0.0
            cls = raw * scale + b
        return cls + (self.served(b + self.shift * fg) - b)

    def commit(self, ref, x):
        """Add the chosen shift to the foreground classes' biases."""
        _, b = self._last_conv(ref, len(ref.anchors),
                               len(ref.cfg["lbls"]) + 1, x)
        b[:, 1:] += self.shift

    @staticmethod
    def _last_conv(ref, A, NC, like):
        w = ref.p("cls_tower.Conv_2.weight",
                  (A * NC, int(ref.cfg["head_hidden"]), 1, 1), "conv_w", like)
        bias = ref.p("cls_tower.Conv_2.bias", (A * NC,), "conv_b", like)
        return w, bias.view(A, NC)


def anchor_mixing(anchors, power: float) -> torch.Tensor:
    """[A, A]: row a weighs anchor b by the IoU of their boxes put on one
    centre, raised to `power`, scaled to unit norm, so that weights drawn
    alike for every anchor keep their variance and anchors of like boxes
    come out correlated."""
    a = torch.as_tensor(np.asarray(anchors)[:, :4], dtype=torch.float64)
    w = a[:, 2] - a[:, 0] + 1.0
    h = a[:, 3] - a[:, 1] + 1.0
    inter = torch.minimum(w[:, None], w) * torch.minimum(h[:, None], h)
    k = (inter / (w[:, None] * h[:, None] + w * h - inter)) ** power
    return (k / k.square().sum(1, keepdim=True).sqrt()).float()


def _bisect(count, target: float, lo: float, hi: float, steps: int):
    """The least c in [lo, hi], to `steps` halvings, with count(c) >=
    target, for a count that grows with c."""
    for _ in range(steps):
        mid = (lo + hi) / 2
        lo, hi = (lo, mid) if count(mid) >= target else (mid, hi)
    return hi


def calibrate(weights: Dict[str, torch.Tensor], cfg: dict, anchors, means,
              stds, seed: int, size, images: int, scale_factor: float,
              offset_std: float, delta_std: float, anchor_iou_power: float,
              logit_std: float, car_lead: float,
              detections_per_image: float) -> None:
    """Fit, in place, the weights that a trained detector has at a known
    scale and a random one does not, by float32 passes of the reference
    over `images` standard-normal images of `size` (H, W) drawn from
    `seed`: each neck offset/mask convolution (layer after layer) to
    outputs of deviation `offset_std` pixels, each tower's last convolution
    (`Calibration.last_conv`), the class logits' scale and Car lead
    (`Calibration.classes`), and then one shift of the foreground classes'
    biases, bisected over passes of the head alone, to the least at which
    the reference's decode and NMS keep `detections_per_image` rows an
    image on average."""
    dev = next(iter(weights.values())).device
    f32 = {k: v.float() for k, v in weights.items()}
    ref = Ref(cfg, Params(f32), anchors=anchors, means=means, stds=stds)
    cal = ref.calibration = Calibration(
        next(iter(weights.values())).dtype, offset_std, delta_std,
        anchor_iou_power, logit_std, car_lead)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (2 ** 63))
    image = torch.randn((images, int(size[0]), int(size[1]), 3),
                        generator=gen, device=dev)
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                  device=dev)
    rois = f(locate_anchors(anchors, cfg))
    table = (f(anchors), f(means), f(stds))

    def found(shift):
        cal.shift = shift
        out = ref.head(x)
        return sum(int((rdecode.detections(
            cfg, rois, *table, out["scores"][b], out["cls_pred"][b],
            out["bbox_2d"][b], out["bbox_3d"][b], scale_factor)[:, 4] >= 0)
            .sum()) for b in range(images)) / images

    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 throughout
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            x = ref.features(image)
            ref.head(x)
            cal.shift = _bisect(found, detections_per_image, -SHIFT, SHIFT,
                                SHIFT_STEPS)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    cal.commit(ref, x)
    for k, v in weights.items():
        v.copy_(f32[k])

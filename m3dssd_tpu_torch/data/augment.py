"""Image transforms (numpy, no OpenCV): the eval chain (float conversion,
zero padding to the test size, normalisation) and the train chain
(photometric distortion, random mirror, random scale-and-shift warp to the
crop size, normalisation).

Each transform takes and returns (image HxWxC float32 BGR, imobj), so the
chain composes like the reference package's; the train transforms draw from
the `rng` (a numpy Generator) the loader passes per sample. The warp and the HSV
conversions are the port's own forms of OpenCV's `warpAffine` (bilinear,
zero border) and `cvtColor`: the machine with the card has no OpenCV.
"""

from __future__ import annotations

import math

import numpy as np

from .. import geometry as geo


class Compose:
    """Chain of transforms; `rng` is passed to each (the eval transforms
    draw nothing from it)."""

    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img, imobj=None, rng=None):
        for t in self.transforms:
            img, imobj = t(img, imobj, rng=rng)
        return img, imobj


class ConvertToFloat:
    def __call__(self, image, imobj=None, rng=None):
        return image.astype(np.float32), imobj


class Normalize:
    """x/255, subtract the ImageNet mean, divide by its std (per 3-channel
    group)."""

    def __init__(self, mean, stds):
        self.mean = np.array(mean, dtype=np.float32)
        self.stds = np.array(stds, dtype=np.float32)

    def __call__(self, image, imobj=None, rng=None):
        image = image.astype(np.float32) / 255.0
        reps = image.shape[2] // self.mean.shape[0]
        image -= np.tile(self.mean, reps)
        image /= np.tile(self.stds, reps)
        return image, imobj


class Padding:
    """Zero-pad bottom/right to `size` (a larger image is cropped); the
    image keeps its scale, so imobj.scale_factor = 1."""

    def __init__(self, size):
        self.size = size

    def __call__(self, image, imobj=None, rng=None):
        h, w = image.shape[:2]
        padded = np.zeros((self.size[0], self.size[1], image.shape[2]),
                          dtype=image.dtype)
        padded[:min(h, self.size[0]), :min(w, self.size[1])] = \
            image[:self.size[0], :self.size[1]]
        if imobj is not None:
            imobj.scale_factor = 1.0
        return padded, imobj


class RandomMirror:
    """Flip the image left-right with probability `mirror_prob`, with the
    gts' 2D boxes, projected centers, rotY and alpha."""

    def __init__(self, mirror_prob, rng=None):
        self.mirror_prob = mirror_prob
        self.rng = rng if rng is not None else np.random

    def __call__(self, image, imobj, rng=None):
        rng = rng if rng is not None else self.rng
        if rng.random() > self.mirror_prob:
            return image, imobj
        image = np.ascontiguousarray(image[:, ::-1, :])
        W = image.shape[1]
        for gt in imobj.gts:
            if "bbox_full" in gt:
                gt.bbox_full[0] = W - gt.bbox_full[0] - gt.bbox_full[2]
            if "bbox_3d" in gt:
                gt.bbox_3d[0] = W - gt.bbox_3d[0] - 1
                rotY = gt.bbox_3d[10]
                rotY = (-math.pi - rotY) if rotY < 0 else (math.pi - rotY)
                rotY = float(geo.snap_to_pi(rotY))
                cx2d, cy2d, cz2d = gt.bbox_3d[0], gt.bbox_3d[1], gt.bbox_3d[2]
                coord3d = imobj.p2_inv @ np.array([cx2d * cz2d, cy2d * cz2d,
                                                   cz2d, 1.0])
                alpha = float(geo.convert_rot_to_alpha(rotY, coord3d[2],
                                                       coord3d[0]))
                gt.bbox_3d[10] = rotY
                gt.bbox_3d[6] = alpha
        return image, imobj


def _affine_scale_about(cx, cy, scale):
    """2x3 affine of a uniform scale about (cx, cy)."""
    return np.array([[scale, 0.0, (1 - scale) * cx],
                     [0.0, scale, (1 - scale) * cy]], dtype=np.float64)


def warp_affine(im, mat, dst_w: int, dst_h: int):
    """OpenCV's `warpAffine(im, mat, (dst_w, dst_h))` with INTER_LINEAR and
    a zero constant border, for float32 images of any channel count and an
    axis-aligned `mat` (a scale and a shift, as RandomTransform makes).

    As OpenCV 5 does it: invert `mat`, map each output pixel to float32
    source coordinates (OpenCV 4 quantised them to 1/32 pixel; OpenCV 5
    does not), and blend the 4 neighbours as ((v00 (1-tx) + v01 tx) (1-ty)
    + (v10 (1-tx) + v11 tx) ty), a neighbour outside the image reading 0.
    With an axis-aligned matrix x depends on the column only and y on the
    row only, so the blend runs separably: two row gathers, then two
    column gathers per row. Agrees with OpenCV 5.0 to about 4e-3 on 0..255
    pixel values (float32 rounding).
    """
    m = np.asarray(mat, np.float64).reshape(2, 3)
    if m[0, 1] != 0 or m[1, 0] != 0:
        raise NotImplementedError("warp_affine takes axis-aligned matrices")
    d = m[0, 0] * m[1, 1]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = np.float32(m[1, 1] * d), np.float32(m[0, 0] * d)
    b1 = np.float32(-(m[1, 1] * d) * m[0, 2])
    b2 = np.float32(-(m[0, 0] * d) * m[1, 2])
    X = a11 * np.arange(dst_w, dtype=np.float32) + b1
    Y = a22 * np.arange(dst_h, dtype=np.float32) + b2
    fx, fy = np.floor(X), np.floor(Y)
    tx, ty = (X - fx)[None, :, None], (Y - fy)[:, None, None]
    H, W = im.shape[:2]
    # the source inside a border of zeros; out-of-range neighbours index it
    src = np.zeros((H + 2, W + 2, im.shape[2]), np.float32)
    src[1:-1, 1:-1] = im
    ix = np.clip(fx.astype(np.int64) + 1, 0, W + 1)
    iy = np.clip(fy.astype(np.int64) + 1, 0, H + 1)
    ix1 = np.clip(fx.astype(np.int64) + 2, 0, W + 1)
    iy1 = np.clip(fy.astype(np.int64) + 2, 0, H + 1)
    one = np.float32(1.0)

    def row_blend(rows):
        return rows[:, ix] * (one - tx) + rows[:, ix1] * tx

    return (row_blend(src[iy]) * (one - ty)
            + row_blend(src[iy1]) * ty)


class RandomTransform:
    """With probability `distort_prob`, scale by 1 + N(0, scale) (clipped
    to +-scale) about a point shifted by N(0, shift) (clipped to +-2 shift)
    of the image size; then warp to the crop size (dst_w x dst_h) and move
    the gts' boxes, projected centers, camera centers and rotY with it."""

    def __init__(self, distort_prob=0.7, shift=0.1, scale=0.4,
                 dst_h=384, dst_w=1280, rng=None):
        self.distort_prob = distort_prob
        self.shift = shift
        self.scale = scale
        self.dst = (dst_w, dst_h)
        self.rng = rng if rng is not None else np.random

    def __call__(self, im, imobj=None, rng=None):
        rng = rng if rng is not None else self.rng
        if rng.random() < self.distort_prob:
            scale = float(np.clip(rng.standard_normal() * self.scale,
                                  -self.scale, self.scale) + 1)
            cx = im.shape[1] * (0.5 + float(np.clip(
                rng.standard_normal() * self.shift,
                -2 * self.shift, 2 * self.shift)))
            cy = im.shape[0] * (0.5 + float(np.clip(
                rng.standard_normal() * self.shift,
                -2 * self.shift, 2 * self.shift)))
            aug = True
        else:
            scale, cx, cy, aug = 1.0, im.shape[1] * 0.5, im.shape[0] * 0.5, \
                False

        mat = _affine_scale_about(cx, cy, scale)
        im = warp_affine(im, mat, *self.dst)

        if imobj is not None:
            imobj.scale_factor = scale
            if "gts" in imobj and aug:
                for gt in imobj.gts:
                    if "bbox_full" in gt:
                        gt.bbox_full[2:4] *= scale
                        gt.bbox_full[0:2] = mat @ np.array(
                            [gt.bbox_full[0], gt.bbox_full[1], 1.0])
                    if "bbox_3d" in gt:
                        cxy = mat @ np.array([gt.bbox_3d[0], gt.bbox_3d[1],
                                              1.0])
                        cz2d = gt.bbox_3d[2] / scale
                        gt.bbox_3d[0:3] = [cxy[0], cxy[1], cz2d]
                        c3d = imobj.p2_inv @ np.array(
                            [cxy[0] * cz2d, cxy[1] * cz2d, cz2d, 1.0])
                        gt.center_3d = [c3d[0], c3d[1], c3d[2]]
                        gt.bbox_3d[7:10] = [c3d[0], c3d[1], c3d[2]]
                        gt.bbox_3d[10] = float(geo.convert_alpha_to_rot(
                            gt.bbox_3d[6], c3d[2], c3d[0]))
        return im, imobj


def bgr_to_hsv(image):
    """BGR -> HSV on float32 images, OpenCV's float convention (the port's
    own form of `cv2.cvtColor(..., COLOR_BGR2HSV)`): H in degrees [0, 360),
    S in [0, 1], V on the input's scale."""
    b, g, r = image[..., 0], image[..., 1], image[..., 2]
    eps = np.float32(np.finfo(np.float32).eps)
    v = np.maximum(np.maximum(r, g), b)
    vmin = np.minimum(np.minimum(r, g), b)
    diff = v - vmin
    s = diff / (np.abs(v) + eps)
    k = np.float32(60.0) / (diff + eps)
    h = np.where(v == r, (g - b) * k,
                 np.where(v == g, (b - r) * k + np.float32(120.0),
                          (r - g) * k + np.float32(240.0)))
    h = np.where(h < 0, h + np.float32(360.0), h)
    return np.stack([h, s, v], axis=-1).astype(np.float32)


def hsv_to_bgr(hsv):
    """HSV -> BGR on float32 images, the inverse of `bgr_to_hsv` (OpenCV's
    `COLOR_HSV2BGR` float form: six sectors of 60 degrees)."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    h = np.fmod(h * np.float32(6.0 / 360.0), np.float32(6.0))
    h = np.where(h < 0, h + np.float32(6.0), h)
    sector = np.floor(h)
    h = h - sector
    sector = sector.astype(np.int64)
    bad = (sector < 0) | (sector >= 6)
    sector = np.where(bad, 0, sector)
    h = np.where(bad, np.float32(0.0), h)
    tab = np.stack([v, v * (1 - s), v * (1 - s * h), v * (1 - s * (1 - h))],
                   axis=-1)
    sector_data = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1],
                            [0, 2, 1], [0, 1, 3], [2, 1, 0]])
    out = np.take_along_axis(tab, sector_data[sector], axis=-1)
    grey = (s == 0)[..., None]
    return np.where(grey, v[..., None], out).astype(np.float32)


class PhotometricDistort:
    """Brightness, contrast, saturation and hue jitter, each with
    probability `distort_prob` (off in every stock config).

    Each of the five steps draws `rng.random()` and fires when it is
    `<= distort_prob`, and draws its factor only when it fires, so a
    sample's later draws (mirror, warp) follow the same sequence as the
    reference package's. Only the input of the BGR -> HSV conversion is
    clipped to [0, 255]. Takes 3-channel images only, as OpenCV's
    conversion does.
    """

    def __init__(self, distort_prob, rng=None):
        self.p = distort_prob
        self.rng = rng if rng is not None else np.random

    def __call__(self, image, imobj=None, rng=None):
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError("photometric distortion takes a 3-channel BGR "
                             f"image, got shape {image.shape}")
        rng = rng if rng is not None else self.rng
        image = image.copy()
        if rng.random() <= self.p:  # brightness
            image += rng.uniform(-32, 32)
        if rng.random() <= self.p:  # contrast
            image *= rng.uniform(0.5, 1.5)
        hsv = bgr_to_hsv(np.clip(image, 0, 255))
        if rng.random() <= self.p:  # saturation
            hsv[:, :, 1] *= rng.uniform(0.5, 1.5)
        if rng.random() <= self.p:  # hue
            hsv[:, :, 0] = (hsv[:, :, 0] + rng.uniform(-18, 18)) % 360.0
        image = hsv_to_bgr(hsv)
        if rng.random() <= self.p:  # contrast (second chance)
            image *= rng.uniform(0.5, 1.5)
        return image, imobj


class Augmentation:
    """The train chain: float, photometric distortion (conf.distort_prob >
    0), random mirror, random warp to the crop size, normalise."""

    def __init__(self, conf, rng=None):
        steps = [ConvertToFloat()]
        if conf.distort_prob > 0:
            steps.append(PhotometricDistort(conf.distort_prob, rng))
        steps += [
            RandomMirror(conf.mirror_prob, rng),
            RandomTransform(conf.trans_prob, conf.shift, conf.scale_trans,
                            dst_h=conf.crop_size[0], dst_w=conf.crop_size[1],
                            rng=rng),
            Normalize(conf.image_means, conf.image_stds),
        ]
        self.augment = Compose(steps)

    def __call__(self, img, imobj, rng=None):
        """rng: the per-sample numpy Generator the loader passes."""
        return self.augment(img, imobj, rng=rng)


class Preprocess:
    """Eval pipeline: float, pad to the test size, normalise."""

    def __init__(self, size, mean, stds):
        self.preprocess = Compose([ConvertToFloat(), Padding(size),
                                   Normalize(mean, stds)])

    def __call__(self, img, imobj=None, rng=None):
        return self.preprocess(img, imobj)

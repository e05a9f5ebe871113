"""KITTI parsing and the dataset (numpy on the host).

Calibration and label parsing, the image database of a KITTI-layout split
and `Kitti3DDataset`, which yields preprocessed eval samples
`{"input": [H, W, 3] float32 RGB, "meta": {p2, p2_inv, imH, imW,
scale_factor, id}}` and, in the train phase, augmented samples with their
anchor targets (`"target"`, from `targets.build_targets`). Image sizes come
from the PNG header, so scanning a split needs no image codec; decoding an
image needs OpenCV (`cv2`), imported only when an image is read. Without
it, pass decoded images through an in-memory dataset with the same
contract (`data.synthetic.SyntheticEvalSet`, `SyntheticTrainSet`).
"""

from __future__ import annotations

import copy
import logging
import os
import pickle
import re
import struct
import threading
from glob import glob
from typing import List, Optional

import numpy as np

from .. import geometry as geo
from .augment import Augmentation, Preprocess


class AttrDict(dict):
    """Minimal attribute-style dict."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k)

    def __setattr__(self, k, v):
        self[k] = v


_FLOAT = r"[-+]?\d*\.\d+|[-+]?\d+"


def read_kitti_cal(calfile: str) -> np.ndarray:
    """Parse the P2 camera projection matrix into a padded 4x4."""
    p2 = None
    with open(calfile, "r") as f:
        for line in f:
            if not line.startswith("P2:"):
                continue
            vals = [float(v) for v in line.split()[1:]]
            if len(vals) != 12:
                continue
            p2 = np.zeros([4, 4], dtype=np.float64)
            p2[:3, :] = np.array(vals).reshape(3, 4)
            p2[3, 3] = 1.0
    if p2 is None:
        raise ValueError(f"no P2 line in {calfile}")
    return p2


_LABEL_RE = re.compile(
    r"([a-zA-Z\-\?\_]+)" + r"\s+(%s)" % _FLOAT * 14 + r"\s*((%s)?)\s*$" % _FLOAT)


def read_kitti_label(file: str, p2: np.ndarray,
                     use_3d_for_2d: bool = False) -> List[AttrDict]:
    """Parse a KITTI label file (see `parse_kitti_label`)."""
    with open(file, "r") as f:
        return parse_kitti_label(f, p2, use_3d_for_2d)


def parse_kitti_label(lines, p2: np.ndarray,
                      use_3d_for_2d: bool = False) -> List[AttrDict]:
    """Parse KITTI label lines into per-object AttrDicts, notably
    `bbox_full` = [x, y, w, h] and `bbox_3d` =
    [cx2d, cy2d, cz2d, w3d, h3d, l3d, alpha, cx3d, cy3d, cz3d, rotY], where
    (cx2d, cy2d) is the projected 3D center and cy3d is moved to the box
    middle (the KITTI y is the bottom face)."""
    gts = []
    for line in lines:
        m = _LABEL_RE.match(line.strip())
        if m is None:
            continue
        g = m.groups()
        cls = g[0]
        trunc, occ = float(g[1]), float(g[2])
        x, y, x2, y2 = (float(g[i]) for i in range(4, 8))
        h3d, w3d, l3d = float(g[8]), float(g[9]), float(g[10])
        cx3d, cy3d, cz3d = float(g[11]), float(g[12]), float(g[13])
        rotY = float(g[14])

        ign = False
        cy3d -= h3d / 2  # re-center from bottom face to box center
        elevation = 1.65 - cy3d

        width = x2 - x + 1
        height = y2 - y + 1

        if use_3d_for_2d and h3d > 0 and w3d > 0 and l3d > 0:
            verts, c3d = geo.project_3d(p2, cx3d, cy3d, cz3d, w3d, h3d,
                                        l3d, rotY, return_3d=True)
            if np.any(c3d[2, :] <= 0):
                ign = True
            else:
                x, y = verts[:, 0].min(), verts[:, 1].min()
                x2, y2 = verts[:, 0].max(), verts[:, 1].max()
                width = x2 - x + 1
                height = y2 - y + 1

        coord = p2 @ np.array([cx3d, cy3d, cz3d, 1.0])
        cx, cy, cz2d = coord[0] / coord[2], coord[1] / coord[2], coord[2]

        vis = {0: 1.0, 1: 0.66, 2: 0.33}.get(int(occ), 0.0)
        rotY = float(geo.snap_to_pi(rotY))
        alpha = float(geo.convert_rot_to_alpha(rotY, cz3d, cx3d))

        gts.append(AttrDict(
            elevation=elevation, cls=cls, occ=occ > 0, ign=ign,
            visibility=vis, trunc=trunc, alpha=alpha, rotY=rotY,
            bbox_full=np.array([x, y, width, height], dtype=np.float64),
            bbox_3d=[cx, cy, cz2d, w3d, h3d, l3d, alpha, cx3d, cy3d,
                     cz3d, rotY],
            center_3d=[cx3d, cy3d, cz3d]))
    return gts


_PHASE_DIR = {"train": "training", "validation": "validation",
              "test": "testing"}
_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _image_size(path: str):
    """(height, width) of an image: from the IHDR chunk of a PNG, else by
    decoding it with OpenCV."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] == _PNG_SIG and head[12:16] == b"IHDR":
        w, h = struct.unpack(">II", head[16:24])
        return int(h), int(w)
    im = _imread(path)
    return im.shape[0], im.shape[1]


def _imread(path: str) -> np.ndarray:
    """Decode an image (BGR uint8) with OpenCV."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "decoding KITTI images needs OpenCV (cv2), which is not "
            "installed; pass decoded images through an in-memory dataset "
            "such as data.synthetic.SyntheticEvalSet") from e
    im = cv2.imread(path)
    if im is None:
        raise FileNotFoundError(f"cannot read image {path}")
    return im


def build_imdb(conf, data_root: str, phase: str,
               cache_folder: Optional[str] = None) -> List[AttrDict]:
    """Scan the eval split `phase` ("validation" or "test") of a
    KITTI-layout dataset into a list of per-image AttrDicts, cached as a
    pickle in `cache_folder` when given."""
    if phase not in _PHASE_DIR:
        raise ValueError(f"phase {phase!r}: the port reads the eval phases "
                         f"{sorted(_PHASE_DIR)}")
    fname = phase + "_imdb.pkl"
    if cache_folder and os.path.exists(os.path.join(cache_folder, fname)):
        logging.info("Preloading imdb.")
        with open(os.path.join(cache_folder, fname), "rb") as f:
            return pickle.load(f)

    imdb = []
    for dbind, db in enumerate(getattr(conf, f"datasets_{phase}")):
        base = os.path.join(data_root, db["name"], _PHASE_DIR[phase])
        im_folder = os.path.join(base, "image_2")
        cal_folder = os.path.join(base, "calib")
        for impath in sorted(glob(os.path.join(im_folder, "*" + db["im_ext"]))):
            iid = os.path.splitext(os.path.basename(impath))[0]
            if "_" in iid:
                continue  # earlier frame of a video_det stack, not an image id
            p2 = read_kitti_cal(os.path.join(cal_folder, iid + ".txt"))
            gts = None
            if phase == "train":
                gts = read_kitti_label(os.path.join(base, "label_2",
                                                    iid + ".txt"),
                                       p2, conf.use_3d_for_2d)
            imH, imW = _image_size(impath)
            imdb.append(AttrDict(id=iid, gts=gts, p2=p2,
                                 p2_inv=np.linalg.inv(p2), path=impath,
                                 imH=imH, imW=imW, dbname=db["name"],
                                 scale=db["scale"], dbind=dbind))

    if cache_folder:
        os.makedirs(cache_folder, exist_ok=True)
        with open(os.path.join(cache_folder, fname), "wb") as f:
            pickle.dump(imdb, f)
    return imdb


def eval_sample(im: np.ndarray, imobj: AttrDict, transform):
    """One eval sample from a decoded BGR image: preprocess, BGR -> RGB per
    3-channel group, and the meta the driver needs."""
    im, imobj = transform(im, imobj)
    groups = [im[:, :, i:i + 3][:, :, ::-1] for i in range(0, im.shape[2], 3)]
    im = np.ascontiguousarray(np.concatenate(groups, axis=2))
    return {"input": im.astype(np.float32),
            "meta": {"p2": imobj.p2, "p2_inv": imobj.p2_inv,
                     "imH": imobj.imH, "imW": imobj.imW,
                     "scale_factor": imobj.get("scale_factor", 1.0),
                     "id": imobj.id}}


def train_sample(im: np.ndarray, imobj: AttrDict, transform, conf, rois,
                 rng=None):
    """One train sample from a decoded BGR image and a copy of its imdb
    entry: augment (drawing from `rng`), BGR -> RGB per 3-channel group,
    and the anchor targets of the augmented gts over `rois` ("target"), or
    with `pre_compute_target` off only the padded gts ("gt"), whose targets
    the train step assigns on the device."""
    from ..targets import build_gt_arrays, build_targets

    im, imobj = transform(im, imobj, rng=rng)
    groups = [im[:, :, i:i + 3][:, :, ::-1] for i in range(0, im.shape[2], 3)]
    im = np.ascontiguousarray(np.concatenate(groups, axis=2))
    sample = {"input": im.astype(np.float32),
              "meta": {"p2": imobj.p2, "p2_inv": imobj.p2_inv,
                       "imH": imobj.imH, "imW": imobj.imW,
                       "scale_factor": imobj.get("scale_factor", 1.0),
                       "id": imobj.id}}
    if conf.pre_compute_target:
        sample["target"] = build_targets(conf, imobj, rois=rois)
    else:
        sample["gt"] = build_gt_arrays(conf, imobj)
    return sample


def prepare_train(conf, imdb, cache_folder: Optional[str] = None):
    """Anchors and whitening statistics from the train imdb when conf has
    none (written onto conf, cached in `cache_folder` when given); returns
    the train rois [N, 5] at conf.feat_size."""
    from ..anchors import compute_bbox_stats, generate_anchors, \
        locate_anchors

    if conf.anchors is None:
        generate_anchors(conf, imdb, cache_folder)
        compute_bbox_stats(conf, imdb, cache_folder)
    return locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)


class Kitti3DDataset:
    """Dataset over a KITTI-layout split: `ds[i]` (or `ds.sample(i, rng)`)
    is the sample of image i.

    Eval phases ("validation", "test") preprocess deterministically; their
    decoded samples are cached up to conf.eval_image_cache_mb MiB (0 turns
    the cache off), so a second pass skips decode, pad and normalise. The
    "train" phase builds anchors and whitening stats when conf has none,
    augments with the per-sample `rng` and adds the anchor targets. Safe to
    read from several prefetch threads.
    """

    def __init__(self, conf, data_root: str, phase: str = "validation",
                 cache_folder: Optional[str] = None, imdb=None):
        if phase not in _PHASE_DIR:
            raise ValueError(f"phase {phase!r}: one of {sorted(_PHASE_DIR)}")
        self.conf = conf
        self.phase = phase
        self.imdb = imdb if imdb is not None else build_imdb(
            conf, data_root, phase, cache_folder)
        self.rois = None
        if phase == "train":
            self.rois = prepare_train(conf, self.imdb, cache_folder)
            self.transform = Augmentation(conf)
        else:
            self.transform = Preprocess(conf.test_scale, conf.image_means,
                                        conf.image_stds)
        self._cache_cap = 0 if phase == "train" else \
            int(getattr(conf, "eval_image_cache_mb", 0)) << 20
        self._cache: dict = {}
        self._cache_bytes = 0
        self._lock = threading.Lock()

    def __len__(self):
        return len(self.imdb)

    def read_image(self, index: int) -> np.ndarray:
        """The image (BGR uint8); with conf.video_det, the `video_count`
        previous frames (`<id>_NN.png`) stacked as extra channel groups, the
        current frame standing in for a missing one."""
        path = self.imdb[index].path
        im = _imread(path)
        if not getattr(self.conf, "video_det", False):
            return im
        base, ext = os.path.splitext(path)
        frames = [im]
        for k in range(1, self.conf.video_count + 1):
            prev = f"{base}_{k:02d}{ext}"
            frames.append(_imread(prev) if os.path.exists(prev) else im)
        return np.concatenate(frames, axis=2)

    def __getitem__(self, index: int):
        return self.sample(index)

    def sample(self, index: int, rng=None):
        if self.phase == "train":
            return train_sample(self.read_image(index),
                                copy.deepcopy(self.imdb[index]),
                                self.transform, self.conf, self.rois, rng)
        with self._lock:
            hit = self._cache.get(index)
        if hit is not None:
            return hit
        sample = eval_sample(self.read_image(index),
                             copy.deepcopy(self.imdb[index]), self.transform)
        with self._lock:
            if self._cache_bytes < self._cache_cap \
                    and index not in self._cache:
                self._cache[index] = sample
                self._cache_bytes += sample["input"].nbytes
        return sample

"""Synthetic mini-KITTI scenes for tests and smoke runs.

3D boxes are placed in camera space, projected with a realistic P2, and
their 2D boxes and alpha derived the way KITTI defines them, so labels are
geometrically consistent. `generate` writes a KITTI-layout directory
(image_2/, calib/, label_2/; needs OpenCV to write the PNGs);
`SyntheticEvalSet` and `SyntheticTrainSet` keep an eval or a train split in
memory and need no image codec.
"""

from __future__ import annotations

import copy
import os

import numpy as np

from .. import geometry as geo
from .augment import Augmentation, Preprocess
from .kitti import (AttrDict, eval_sample, parse_kitti_label, prepare_train,
                    train_sample)

# A realistic KITTI P2 (from the devkit's example calibration).
DEFAULT_P2 = np.array([
    [721.5377, 0.0, 609.5593, 44.85728],
    [0.0, 721.5377, 172.854, 0.2163791],
    [0.0, 0.0, 1.0, 0.002745884],
    [0.0, 0.0, 0.0, 1.0],
])


def scaled_p2(im_scale: float) -> np.ndarray:
    """P2 for a camera downscaled by `im_scale` (rows 0-1 scale with pixels)."""
    p2 = DEFAULT_P2.copy()
    p2[0:2] *= im_scale
    return p2


_CLASS_DIMS = {
    # cls: (h3d, w3d, l3d) mean dimensions
    "Car": (1.5, 1.6, 3.9),
    "Pedestrian": (1.75, 0.6, 0.8),
    "Cyclist": (1.75, 0.6, 1.76),
}


def make_scene(rng, num_objs, imW=1242, imH=375, classes=("Car",), p2=None,
               min_h_px=25):
    """Sample consistent 3D objects visible in the image. Returns label rows."""
    p2 = DEFAULT_P2 if p2 is None else p2
    rows = []
    for _ in range(num_objs):
        for _attempt in range(50):
            cls = classes[rng.integers(len(classes))]
            h3d, w3d, l3d = _CLASS_DIMS[cls]
            h3d *= rng.uniform(0.9, 1.1)
            w3d *= rng.uniform(0.9, 1.1)
            l3d *= rng.uniform(0.9, 1.1)
            z = rng.uniform(8.0, 45.0)
            x = rng.uniform(-0.04, 0.04) * z * 18
            ybot = 1.65  # ground plane
            ry = rng.uniform(-np.pi, np.pi)
            ycen = ybot - h3d / 2
            verts, c3d = geo.project_3d(p2, x, ycen, z, w3d, h3d, l3d,
                                        ry, return_3d=True)
            if np.any(c3d[2] <= 0):
                continue
            x1, y1 = verts[:, 0].min(), verts[:, 1].min()
            x2, y2 = verts[:, 0].max(), verts[:, 1].max()
            if x1 < 0 or y1 < 0 or x2 >= imW or y2 >= imH:
                continue
            if (y2 - y1) < min_h_px:  # visible height floor
                continue
            alpha = float(geo.convert_rot_to_alpha(ry, z, x))
            rows.append(dict(cls=cls, trunc=0.0, occ=0,
                             alpha=alpha, x1=x1, y1=y1, x2=x2, y2=y2,
                             h=h3d, w=w3d, l=l3d, x=x, y=ybot, z=z, ry=ry))
            break
    return rows


def render_image(rows, imW=1242, imH=375, rng=None):
    """Simple render: textured background + bright filled 2D boxes with a
    depth-coded intensity so the detector has a learnable signal."""
    rng = rng or np.random.default_rng(0)
    im = (rng.uniform(40, 90, size=(imH, imW, 3))).astype(np.float32)
    # horizon gradient
    im += np.linspace(0, 40, imH)[:, None, None]
    for r in sorted(rows, key=lambda r: -r["z"]):  # far first (painter's algo)
        x1, y1 = int(max(0, r["x1"])), int(max(0, r["y1"]))
        x2, y2 = int(min(imW - 1, r["x2"])), int(min(imH - 1, r["y2"]))
        shade = 255.0 * (1.0 - r["z"] / 60.0)
        color = {"Car": (shade, 60, 60), "Pedestrian": (60, shade, 60),
                 "Cyclist": (60, 60, shade)}[r["cls"]]
        im[y1:y2 + 1, x1:x2 + 1] = np.array(color, dtype=np.float32)
        # orientation cue: a darker band on the heading side
        mid = (x1 + x2) // 2
        if np.cos(r["ry"]) > 0:
            im[y1:y2 + 1, mid:x2 + 1] *= 0.6
        else:
            im[y1:y2 + 1, x1:mid + 1] *= 0.6
    return np.clip(im, 0, 255).astype(np.uint8)


def _label_line(r):
    return (f"{r['cls']} {r['trunc']:.2f} {r['occ']} {r['alpha']:.6f} "
            f"{r['x1']:.2f} {r['y1']:.2f} {r['x2']:.2f} {r['y2']:.2f} "
            f"{r['h']:.2f} {r['w']:.2f} {r['l']:.2f} "
            f"{r['x']:.2f} {r['y']:.2f} {r['z']:.2f} {r['ry']:.6f}")


def _calib_text(p2=None):
    p2 = DEFAULT_P2 if p2 is None else p2
    rows = []
    for name in ["P0", "P1", "P2", "P3"]:
        vals = " ".join(f"{v:.12e}" for v in p2[:3].reshape(-1))
        rows.append(f"{name}: {vals}")
    rows.append("R0_rect: " + " ".join(["1.0e+00" if i % 4 == 0 else "0.0e+00"
                                        for i in range(9)]))
    return "\n".join(rows) + "\n"


def _draw(rng, count, imW, imH, classes, p2, max_objs, min_h_px):
    """`count` (label rows, BGR uint8 image) pairs from one rng stream."""
    for _ in range(count):
        rows = make_scene(rng, int(rng.integers(1, max_objs + 1)), imW, imH,
                          classes, p2=p2, min_h_px=min_h_px)
        yield rows, render_image(rows, imW, imH, rng)


def _write_label(path, rows):
    with open(path, "w") as f:
        f.write("\n".join(_label_line(r) for r in rows) + "\n")


def generate(root: str, num_train=16, num_val=8, seed=0, imW=1242, imH=375,
             classes=("Car",), max_objs=4, dataset_name="kitti_split1",
             min_h_px=25):
    """Write a synthetic KITTI-layout dataset under `root/<dataset_name>`.

    The camera intrinsics scale with imW so scenes stay geometrically sane
    at reduced resolutions. The validation split holds the same scenes as
    `SyntheticEvalSet(conf, num_val, seed)` when num_train is 0.
    """
    import cv2
    p2 = scaled_p2(imW / 1242.0)
    rng = np.random.default_rng(seed)
    base = os.path.join(root, dataset_name)
    specs = [("training", num_train, True), ("validation", num_val, True),
             ("testing", 0, False)]
    for split, count, with_labels in specs:
        for sub in ["image_2", "calib"] + (["label_2"] if with_labels else []):
            os.makedirs(os.path.join(base, split, sub), exist_ok=True)
        scenes = _draw(rng, count, imW, imH, classes, p2, max_objs, min_h_px)
        for i, (rows, im) in enumerate(scenes):
            iid = f"{i:06d}"
            cv2.imwrite(os.path.join(base, split, "image_2", iid + ".png"), im)
            with open(os.path.join(base, split, "calib", iid + ".txt"), "w") as f:
                f.write(_calib_text(p2))
            if with_labels:
                _write_label(os.path.join(base, split, "label_2",
                                          iid + ".txt"), rows)
    return base


class SyntheticEvalSet:
    """An in-memory eval split of `num` synthetic scenes with the sample
    contract of `data.kitti.Kitti3DDataset` (`ds[i]` -> {"input", "meta"}).

    Scenes are drawn as `generate` draws its validation split (the same
    images for the same seed when it writes no training split) and kept as
    uint8 BGR renders; `ds[i]` preprocesses on the calling thread, as a
    decoded image would be. `write_labels(dir)` writes the gt as KITTI
    label txts (`<id>.txt`), the layout `eval.evaluate_kitti` reads.
    """

    def __init__(self, conf, num: int, seed: int = 0, imW: int = 1242,
                 imH: int = 375, classes=("Car",), max_objs: int = 4,
                 min_h_px: int = 25):
        # P2 as its calib file stores it, so a sample equals the one read
        # back from `generate`'s files
        p2 = scaled_p2(imW / 1242.0)
        self.p2 = np.vectorize(lambda v: float(f"{v:.12e}"))(p2)
        self.p2_inv = np.linalg.inv(self.p2)
        self.imW, self.imH = imW, imH
        rng = np.random.default_rng(seed)
        self.scenes = list(_draw(rng, num, imW, imH, classes, p2,
                                 max_objs, min_h_px))
        self.transform = Preprocess(conf.test_scale, conf.image_means,
                                    conf.image_stds)

    def __len__(self):
        return len(self.scenes)

    def image_id(self, index: int) -> str:
        return f"{index:06d}"

    def labels(self, index: int):
        """The gt label rows of scene `index` (dicts of KITTI fields)."""
        return self.scenes[index][0]

    def write_labels(self, folder: str) -> str:
        os.makedirs(folder, exist_ok=True)
        for i, (rows, _) in enumerate(self.scenes):
            _write_label(os.path.join(folder, self.image_id(i) + ".txt"),
                         rows)
        return folder

    def __getitem__(self, index: int):
        imobj = AttrDict(id=self.image_id(index), p2=self.p2,
                         p2_inv=self.p2_inv, imH=self.imH, imW=self.imW)
        return eval_sample(self.scenes[index][1], imobj, self.transform)


class SyntheticTrainSet:
    """An in-memory train split of `num` synthetic scenes with the train
    contract of `data.kitti.Kitti3DDataset` (`ds.sample(i, rng)` -> {"input",
    "meta", "target"}; `ds.imdb`, `ds.rois`, `ds.conf`).

    The scenes are those `generate(root, num_train=num, seed=seed, ...)`
    writes to its training split, and `imdb` holds what `build_imdb` reads
    back from those files (labels and P2 at the precision the files keep),
    so a sample equals the one the KITTI dataset gives from the written
    split; the images stay decoded uint8 BGR. Anchors and whitening stats
    are built from the split when conf has none.
    """

    def __init__(self, conf, num: int, seed: int = 0, imW: int = 1242,
                 imH: int = 375, classes=("Car",), max_objs: int = 4,
                 min_h_px: int = 25):
        p2 = scaled_p2(imW / 1242.0)
        p2_file = np.vectorize(lambda v: float(f"{v:.12e}"))(p2)
        rng = np.random.default_rng(seed)
        self.conf = conf
        self.images, self.imdb = [], []
        db = conf.datasets_train[0]
        for i, (rows, im) in enumerate(_draw(rng, num, imW, imH, classes, p2,
                                             max_objs, min_h_px)):
            lines = [_label_line(r) for r in rows]
            self.images.append(im)
            self.imdb.append(AttrDict(
                id=f"{i:06d}", gts=parse_kitti_label(lines, p2_file,
                                                     conf.use_3d_for_2d),
                p2=p2_file, p2_inv=np.linalg.inv(p2_file), path=None,
                imH=imH, imW=imW, dbname=db["name"], scale=db["scale"],
                dbind=0))
        self.rois = prepare_train(conf, self.imdb)
        self.transform = Augmentation(conf)

    def __len__(self):
        return len(self.imdb)

    def sample(self, index: int, rng=None):
        return train_sample(self.images[index],
                            copy.deepcopy(self.imdb[index]), self.transform,
                            self.conf, self.rois, rng)

    def __getitem__(self, index: int):
        return self.sample(index)

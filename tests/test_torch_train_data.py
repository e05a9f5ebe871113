"""The port's train data path against the JAX package's: anchors and
whitening stats, anchor targets, the train augmentations, the loader's
batches and the in-memory synthetic train split, all on one synthetic
KITTI-layout split written by the JAX package's `generate`.

The warp is the port's own (the card machine has no OpenCV); it agrees
with OpenCV's warpAffine to float32 rounding, about 4e-3 on 0..255 pixel
values, so augmented images are compared at 1e-2 on that scale (5e-4
after normalisation). Everything else that does not touch pixels is
compared exactly, or at 1e-6 where float32 arithmetic is involved.
"""

import copy

import numpy as np
import pytest
import torch

from m3dssd_tpu.config import kitti_3d_anab_fullalign as j_conf_fn
from m3dssd_tpu.data.augment import RandomMirror as JRandomMirror
from m3dssd_tpu.data.augment import RandomTransform as JRandomTransform
from m3dssd_tpu.data.kitti import Kitti3DDataset as JKitti3DDataset
from m3dssd_tpu.data.loader import TrainLoader as JTrainLoader
from m3dssd_tpu.data.synthetic import generate as j_generate
from m3dssd_tpu.targets import build_targets as j_build_targets
from m3dssd_tpu_torch.anchors import locate_anchors
from m3dssd_tpu_torch.config import kitti_3d_anab_fullalign
from m3dssd_tpu_torch.data.augment import (Augmentation, RandomMirror,
                                           RandomTransform, warp_affine)
from m3dssd_tpu_torch.data.kitti import Kitti3DDataset
from m3dssd_tpu_torch.data.loader import TrainLoader
from m3dssd_tpu_torch.data.synthetic import SyntheticTrainSet
from m3dssd_tpu_torch.targets import build_targets

# one torch thread per test process: the suite runs several workers at
# once, and torch's default of one thread per core made them
# oversubscribe the machine and slow every worker down
torch.set_num_threads(1)

CROP = [64, 224]
IM = dict(imW=224, imH=64, min_h_px=6)
NUM, SEED = 8, 3
PIX_ABS = 1e-2          # warp vs OpenCV on 0..255 pixels
IMG_ABS = 5e-4          # the same after /255 and /std


def _confs():
    kw = dict(crop_size=CROP, test_scale=CROP, num_anchor_scales=2,
              back_bone="dla34", pre_train=False, compute_dtype="float32",
              batch_size=2, num_workers=2)
    return j_conf_fn().replace(**kw), kitti_3d_anab_fullalign().replace(**kw)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_train"))
    j_generate(root, num_train=NUM, num_val=0, seed=SEED, **IM)
    jconf, tconf = _confs()
    jds = JKitti3DDataset(jconf, root, phase="train")
    tds = Kitti3DDataset(tconf, root, phase="train")
    return root, jds, tds


def test_anchors_and_bbox_stats_match_jax(data):
    _, jds, tds = data
    np.testing.assert_allclose(tds.conf.anchors, jds.conf.anchors,
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tds.conf.bbox_means, jds.conf.bbox_means,
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tds.conf.bbox_stds, jds.conf.bbox_stds,
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(tds.rois, jds.rois)


def test_build_targets_match_jax(data):
    """Labels exactly, whitened regression targets within 1e-6, for every
    image of the split as read (no augmentation)."""
    _, jds, tds = data
    for i in range(NUM):
        want = j_build_targets(jds.conf, copy.deepcopy(jds.imdb[i]),
                               rois=jds.rois)
        got = build_targets(tds.conf, copy.deepcopy(tds.imdb[i]),
                            rois=tds.rois)
        assert sorted(got) == sorted(want)
        for k in ("labels", "labels_fg", "labels_bg", "labels_ign",
                  "any_val"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("bbox_2d", "bbox_3d"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    assert sum(int(build_targets(tds.conf, tds.imdb[i],
                                 rois=tds.rois)["labels_fg"].sum())
               for i in range(NUM)) > 0


def test_random_mirror_matches_jax_exactly(data):
    _, jds, tds = data
    rng = np.random.default_rng(0)
    for i in range(3):
        im = rng.uniform(0, 255, size=(64, 224, 3)).astype(np.float32)
        jim, jobj = JRandomMirror(1.0)(im.copy(), copy.deepcopy(jds.imdb[i]),
                                       rng=np.random.default_rng(i))
        tim, tobj = RandomMirror(1.0)(im.copy(), copy.deepcopy(tds.imdb[i]),
                                      rng=np.random.default_rng(i))
        np.testing.assert_array_equal(tim, jim)
        for jg, tg in zip(jobj.gts, tobj.gts):
            np.testing.assert_array_equal(tg.bbox_full, jg.bbox_full)
            np.testing.assert_array_equal(np.asarray(tg.bbox_3d),
                                          np.asarray(jg.bbox_3d))


def test_random_transform_matches_jax(data):
    """Same numpy draws, same boxes; the image within the warp's
    tolerance of OpenCV's."""
    _, jds, tds = data
    im0 = np.random.default_rng(1).uniform(0, 255, size=(64, 224, 3)) \
        .astype(np.float32)
    for i in range(4):
        kw = dict(distort_prob=1.0, shift=0.1, scale=0.4, dst_h=CROP[0],
                  dst_w=CROP[1])
        jim, jobj = JRandomTransform(**kw)(
            im0.copy(), copy.deepcopy(jds.imdb[i]),
            rng=np.random.default_rng(10 + i))
        tim, tobj = RandomTransform(**kw)(
            im0.copy(), copy.deepcopy(tds.imdb[i]),
            rng=np.random.default_rng(10 + i))
        assert tim.shape == jim.shape and tim.dtype == np.float32
        assert np.abs(tim - jim).max() <= PIX_ABS
        assert tobj.scale_factor == jobj.scale_factor
        for jg, tg in zip(jobj.gts, tobj.gts):
            np.testing.assert_array_equal(tg.bbox_full, jg.bbox_full)
            np.testing.assert_array_equal(np.asarray(tg.bbox_3d),
                                          np.asarray(jg.bbox_3d))


def test_warp_matches_opencv_on_odd_sizes():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(2)
    for _ in range(4):
        im = rng.uniform(0, 255, size=(int(rng.integers(20, 60)),
                                       int(rng.integers(30, 90)), 3)) \
            .astype(np.float32)
        s = float(1 + np.clip(rng.normal() * 0.4, -0.4, 0.4))
        cx, cy = im.shape[1] * rng.uniform(0.3, 0.7), \
            im.shape[0] * rng.uniform(0.3, 0.7)
        mat = np.array([[s, 0, (1 - s) * cx], [0, s, (1 - s) * cy]])
        dw, dh = int(rng.integers(30, 100)), int(rng.integers(20, 70))
        assert np.abs(warp_affine(im, mat, dw, dh)
                      - cv2.warpAffine(im, mat, (dw, dh))).max() <= PIX_ABS


def _compare_batches(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        w = np.asarray(w)
        assert g.shape == w.shape, k
        if k == "images":
            assert np.abs(g - w).max() <= IMG_ABS
        elif np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_train_loader_batches_match_jax(data):
    """Two batches for one seed: the same images drawn, augmented with the
    same per-sample draws, and the same targets."""
    _, jds, tds = data
    jb = list(JTrainLoader(jds, 2, num_workers=2, seed=5).batches(2))
    tb = list(TrainLoader(tds, 2, num_workers=2, seed=5,
                          pin=False).batches(2))
    assert len(tb) == 2
    for g, w in zip(tb, jb):
        _compare_batches(g, w)


def test_loader_packs_and_casts():
    """pack_s2d gives the model's packed layout and a bf16 conf uploads
    bf16 images; a fresh loader with the same seed repeats its batches."""
    _, tconf = _confs()
    tconf = tconf.replace(compute_dtype="bfloat16")
    ds = SyntheticTrainSet(tconf, 4, seed=1, **IM)
    a = next(TrainLoader(ds, 2, num_workers=2, seed=9, pack_s2d=True,
                         pin=False).batches(1))
    b = next(TrainLoader(ds, 2, num_workers=2, seed=9, pack_s2d=True,
                         pin=False).batches(1))
    assert a["images"].dtype == torch.bfloat16
    assert tuple(a["images"].shape) == (2, CROP[0] // 2, CROP[1] // 2, 12)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_synthetic_train_set_matches_the_written_split(data):
    """The in-memory split holds the scenes `generate` writes, with the
    imdb the KITTI reader builds from the files: the same anchors, and
    bit-identical samples for the same draws, against the port's reader
    and (within the warp's tolerance) the JAX dataset."""
    _, jds, tds = data
    _, conf = _confs()
    syn = SyntheticTrainSet(conf, NUM, seed=SEED, **IM)
    np.testing.assert_array_equal(conf.anchors, tds.conf.anchors)
    np.testing.assert_array_equal(syn.rois, tds.rois)
    assert len(syn) == NUM
    for i in range(NUM):
        a = syn.sample(i, rng=np.random.default_rng(i))
        b = tds.sample(i, rng=np.random.default_rng(i))
        c = jds.sample(i, rng=np.random.default_rng(i))
        np.testing.assert_array_equal(a["input"], b["input"])
        assert np.abs(a["input"] - c["input"]).max() <= IMG_ABS
        for k in a["target"]:
            np.testing.assert_array_equal(a["target"][k], b["target"][k])
            np.testing.assert_array_equal(a["target"][k], c["target"][k])


def test_unported_options_raise():
    """The options that raised until they were ported now run: photometric
    distortion joins the train chain after the float conversion, k-means
    anchors build the train split's anchors (tests/test_torch_capabilities.py
    holds both against JAX)."""
    _, conf = _confs()
    aug = Augmentation(conf.replace(distort_prob=0.5))
    assert type(aug.augment.transforms[1]).__name__ == "PhotometricDistort"
    km = SyntheticTrainSet(conf.replace(cluster_anchors=1), 2, seed=0, **IM)
    assert km.conf.anchors.shape[1] == 9
    assert np.isfinite(km.conf.anchors).all()
    assert km.rois.shape[0] == (km.conf.anchors.shape[0]
                                * int(np.prod(km.conf.feat_size)))
    # on-device targets are ported: the sample carries padded gts
    syn = SyntheticTrainSet(conf.replace(pre_compute_target=False), 2,
                            seed=0, **IM)
    sample = syn.sample(0, rng=np.random.default_rng(0))
    assert "target" not in sample
    assert sample["gt"]["gt_boxes2d"].shape == (conf.max_gts, 4)
    assert locate_anchors(syn.conf.anchors, syn.conf.feat_size,
                          syn.conf.feat_stride).shape == syn.rois.shape

"""The train options the port took last: k-means anchors, photometric
distortion, the depth-aware backbone dla34_depth (LocalConv2d, DepthBlock)
with every option on in one train step, DeformLocConv, NLUp / NLPM, the
val_train phase with the test CLI, the profiling helpers and the
Trainer's TensorBoard writer, each against the JAX package on the CPU.

Tolerances, each stated where it is used:
  * k-means anchors: equal arrays (the same numpy code and draw order);
  * photometric distortion: 1e-2 on the 0..255 pixel scale (the port's
    HSV conversions against OpenCV's, and its warp against warpAffine);
  * modules in float32: 1e-4 (one conv), 1e-3 through a deep chain;
  * one train step: test_torch_train.py's limits (loss and stats 1e-4,
    updates 3e-2 of the largest and 3e-2 median per tensor).

The JAX model is built once, at 512 x 64: dla34_depth's 16 row bands sit
in levels 2-5 (strides 4-32), so the input height must be a multiple of
512, and JAX's LocalConv2d asserts it.
"""

import copy
import json
import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from m3dssd_tpu import anchors as j_anchors
from m3dssd_tpu.config import kitti_3d_anab_fullalign as j_conf_fn
from m3dssd_tpu.data import augment as j_augment
from m3dssd_tpu.data import kitti as j_kitti
from m3dssd_tpu.data.synthetic import generate as j_generate
from m3dssd_tpu.models import build as j_build
from m3dssd_tpu.models.attention import NLPM as JNLPM
from m3dssd_tpu.models.attention import NLUp as JNLUp
from m3dssd_tpu.models.dla import DepthBlock as JDepthBlock
from m3dssd_tpu.models.layers import LocalConv2d as JLocalConv2d
from m3dssd_tpu.models.necks import DeformLocConv as JDeformLocConv
from m3dssd_tpu.train.state import TrainState as JTrainState
from m3dssd_tpu.train.state import freeze_mask_fn as j_freeze_mask_fn
from m3dssd_tpu.train.state import make_optimizer as j_make_optimizer
from m3dssd_tpu.train.state import make_train_step as j_make_train_step
from m3dssd_tpu.utils import torch_import as j_torch_import
from m3dssd_tpu_torch import anchors as t_anchors
from m3dssd_tpu_torch.config import flagship_conf, kitti_3d_anab_fullalign
from m3dssd_tpu_torch.config import kitti_3d_base
from m3dssd_tpu_torch.data import augment as t_augment
from m3dssd_tpu_torch.data import kitti as t_kitti
from m3dssd_tpu_torch.data.loader import EvalLoader
from m3dssd_tpu_torch.data.synthetic import (SyntheticEvalSet,
                                             SyntheticTrainSet)
from m3dssd_tpu_torch.models import build
from m3dssd_tpu_torch.models.attention import NLPM, NLUp
from m3dssd_tpu_torch.models.dla import DepthBlock
from m3dssd_tpu_torch.models.layers import LocalConv2d
from m3dssd_tpu_torch.models.necks import DCN, DeformLocConv
from m3dssd_tpu_torch.scripts import test as test_cli
from m3dssd_tpu_torch.train.state import create_train_state, make_train_step
from m3dssd_tpu_torch.train.trainer import Trainer
from m3dssd_tpu_torch.utils import profiling
from m3dssd_tpu_torch.utils import torch_import as ti
from m3dssd_tpu_torch.utils.checkpoint import save_checkpoint
from m3dssd_tpu_torch.utils.weights import from_flax_variables
from torch_reference_layout import reference_state_dict

# one torch thread per test process: the suite runs several workers at
# once, and torch's default of one thread per core made them
# oversubscribe the machine and slow every worker down
torch.set_num_threads(1)

DEPTH_CROP = (512, 64)
SHALLOW = dict(rtol=1e-4, atol=1e-4)     # one conv or attention, float32
DEEP = dict(rtol=1e-3, atol=1e-3)        # the whole model, float32
PIX_ABS = 1e-2                           # pixels on the 0..255 scale
STEP_TOL = 1e-4                          # test_torch_train.py's limits
UPDATE_TOL = 3e-2
UPDATE_MEDIAN_TOL = 3e-2
OPTIONS = dict(distort_prob=0.5, cluster_anchors=1, bbox_3d_proj_lambda=1.0,
               bbox_3d_iou_lambda=1.0)
P2 = np.array([[721.5377, 0.0, 609.5593, 44.85728],
               [0.0, 721.5377, 172.854, 0.2163791],
               [0.0, 0.0, 1.0, 0.002745884], [0.0, 0.0, 0.0, 1.0]])


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb(variables, seed):
    """Every parameter and statistic moved off its init from a numpy seed:
    BN scale/bias/mean/var, biases, and the zero-initialised offset/mask
    convs (so offsets are fractional)."""
    rng = np.random.default_rng(seed)

    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v, path + (k,))
                continue
            a = np.array(v, np.float32)
            if "conv_offset_mask" in path:
                a = rng.normal(size=a.shape) * (0.3 if k == "bias" else 0.05)
            elif k == "scale":
                a = rng.uniform(0.8, 1.2, size=a.shape)
            elif k == "bias":
                a = a + rng.normal(size=a.shape) * 0.05
            elif k == "mean":
                a = rng.normal(size=a.shape) * 0.1
            elif k == "var":
                a = rng.uniform(0.5, 1.5, size=a.shape)
            out[k] = a.astype(np.float32)
        return out

    return walk(_np_tree(variables), ())


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))) \
        .contiguous(memory_format=torch.channels_last)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------------------
# k-means anchors
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def imdbs(synthetic_kitti, tiny_conf):
    conf = kitti_3d_base().replace(
        crop_size=[192, 640], test_scale=[192, 640], num_anchor_scales=6,
        batch_size=2, num_workers=2, back_bone="dla34",
        compute_dtype="float32", pre_train=False)
    return (tiny_conf, j_kitti.build_imdb(tiny_conf, synthetic_kitti, "train"),
            conf, t_kitti.build_imdb(conf, synthetic_kitti, "train"))


@pytest.mark.parametrize("mode", ["plain", "even", "expand"])
def test_cluster_anchors_equal_jax(imdbs, mode):
    """cluster_anchors in its three modes on the JAX tests' synthetic
    split, and generate_anchors with cluster_anchors on: equal arrays."""
    jconf, jimdb, conf, imdb = imdbs
    over = dict(anchors=None, cluster_anchors=1, num_anchor_scales=2)
    jbase, base = jconf.replace(**over), conf.replace(**over)
    ladder = j_anchors.generate_anchors(jbase.replace(cluster_anchors=0),
                                        jimdb)
    np.testing.assert_array_equal(
        t_anchors.generate_anchors(base.replace(cluster_anchors=0), imdb),
        ladder)
    mode_kw = {"plain": {}, "even": dict(even_anchors=1),
               "expand": dict(expand_anchors=ladder.shape[0] + 4)}[mode]
    want = j_anchors.cluster_anchors(jbase.replace(**mode_kw), ladder, jimdb)
    got = t_anchors.cluster_anchors(base.replace(**mode_kw), ladder.copy(),
                                    imdb)
    assert got.shape[1] == 9 and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    if mode == "plain":
        jc, tc = jbase.replace(), base.replace()
        np.testing.assert_array_equal(t_anchors.generate_anchors(tc, imdb),
                                      j_anchors.generate_anchors(jc, jimdb))
        np.testing.assert_array_equal(tc.anchors, jc.anchors)


# ---------------------------------------------------------------------------
# photometric distortion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [0.5, 1.0])
def test_photometric_distort_matches_opencv_version(p):
    """The port's numpy HSV form against the JAX package's cv2 version
    from the same Generator: every pixel within 1e-2 on the 0..255 scale
    (largest measured 4.6e-4), the same draws consumed (the next draw is
    equal), images with values outside [0, 255] and grey pixels
    included."""
    rng = np.random.default_rng(0)
    worst = 0.0
    for seed in range(12):
        img = (rng.random((24, 40, 3)) * 300 - 20).astype(np.float32)
        img[0, :4] = [[5, 5, 5], [0, 0, 0], [10, 10, 3], [3, 10, 10]]
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        want, _ = j_augment.PhotometricDistort(p)(img, None, rng=r1)
        got, _ = t_augment.PhotometricDistort(p)(img, None, rng=r2)
        assert got.dtype == np.float32
        assert r1.random() == r2.random()
        worst = max(worst, float(np.abs(got - want).max()))
    assert worst <= PIX_ABS, worst
    with pytest.raises(ValueError, match="3-channel"):
        t_augment.PhotometricDistort(p)(np.zeros((4, 4, 6), np.float32),
                                        None, rng=np.random.default_rng(0))


@pytest.mark.parametrize("p", [0.5, 1.0])
def test_augmentation_with_distortion_matches_jax(synthetic_kitti,
                                                  tiny_conf, p):
    """The whole train chain (float, distortion, mirror, warp, normalise)
    on the synthetic split's images from the same Generator: pixels within
    1e-2 on the 0..255 scale and the same boxes after, so the distortion
    draws in the reference's order."""
    conf = kitti_3d_base().replace(crop_size=[192, 640],
                                   test_scale=[192, 640], distort_prob=p)
    jconf = tiny_conf.replace(distort_prob=p)
    imdb = t_kitti.build_imdb(conf, synthetic_kitti, "train")
    jaug, aug = j_augment.Augmentation(jconf), t_augment.Augmentation(conf)
    std = np.asarray(conf.image_stds, np.float32)
    for i in range(4):
        im = t_kitti._imread(imdb[i].path)
        want, jobj = jaug(im, copy.deepcopy(imdb[i]),
                          rng=np.random.default_rng(i))
        got, obj = aug(im, copy.deepcopy(imdb[i]),
                       rng=np.random.default_rng(i))
        # back from (x / 255 - mean) / std to the 0..255 scale
        pix = np.abs((got - want) * std * 255).max()
        assert pix <= PIX_ABS, (i, pix)
        assert obj.scale_factor == jobj.scale_factor
        for g, w in zip(obj.gts, jobj.gts):
            np.testing.assert_allclose(g.bbox_full, w.bbox_full, rtol=0,
                                       atol=1e-9)
            np.testing.assert_allclose(g.bbox_3d, w.bbox_3d, rtol=0,
                                       atol=1e-9)


# ---------------------------------------------------------------------------
# row-banded modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", [2, 4])
def test_local_conv2d_matches_jax(r):
    """Bands fold band-major into channel groups; the weight bridge maps
    the [3, 3, C, r*F] kernel (random, not symmetric) with no reordering."""
    rng = np.random.default_rng(r)
    x = rng.normal(size=(2, 8 * r, 12, 5)).astype(np.float32)
    jmod = JLocalConv2d(num_rows=r, features=6)
    variables = jmod.init(jax.random.PRNGKey(0), x)
    variables = {"params": {"Conv_0": {
        "kernel": rng.normal(size=(3, 3, 5, 6 * r)).astype(np.float32),
        "bias": rng.normal(size=(6 * r,)).astype(np.float32)}}}
    want = np.asarray(jmod.apply(variables, x))
    mod = LocalConv2d(5, r, 6)
    mod.load_state_dict(from_flax_variables(variables), strict=True)
    got = _nhwc(mod(_nchw(x)))
    np.testing.assert_allclose(got, want, **SHALLOW)
    with pytest.raises(ValueError, match="num_rows"):
        mod(_nchw(x[:, :-1]))


@pytest.mark.parametrize("train", [False, True])
def test_depth_block_matches_jax(train):
    """DepthBlock (ConvBNAct without bias, LocalConv2d, bare BatchNorm,
    residual LeakyReLU) in eval mode, and in train mode with its output,
    input gradient and updated BN statistics."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 16, 10, 8)).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    jmod = JDepthBlock(planes=8, num_rows=4)
    variables = _perturb(jmod.init(jax.random.PRNGKey(1), x, train=False), 2)
    mod = DepthBlock(8, 8, num_rows=4)
    mod.load_state_dict(from_flax_variables(variables), strict=True)
    xt = _nchw(x).requires_grad_()
    if not train:
        want = np.asarray(jmod.apply(variables, x, train=False))
        np.testing.assert_allclose(_nhwc(mod.eval()(xt)), want, **SHALLOW)
        return

    def f(xx):
        y, upd = jmod.apply(variables, xx, train=True,
                            mutable=["batch_stats"])
        return jnp.sum(y * ct), (y, upd)

    (_, (want, upd)), gx = jax.value_and_grad(f, has_aux=True)(x)
    y = mod.train()(xt)
    (y * _nchw(ct)).sum().backward()
    np.testing.assert_allclose(_nhwc(y), np.asarray(want), **SHALLOW)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx), **SHALLOW)
    ref = from_flax_variables({"params": variables["params"],
                               "batch_stats": _np_tree(upd["batch_stats"])})
    sd = mod.state_dict()
    for k in ref:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), ref[k].numpy(),
                                       err_msg=k, **SHALLOW)


@pytest.mark.parametrize("train", [False, True])
def test_deform_loc_conv_matches_jax(train):
    """Per-band offsets from one grouped conv and a bilinear gather,
    against JAX in eval and train mode: at init (zero offset/mask conv, so
    0.5x a per-band plain conv) and with perturbed offsets and BN."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 12, 9, 4)).astype(np.float32)
    jmod = JDeformLocConv(features=5, num_rows=3)
    init = jmod.init(jax.random.PRNGKey(2), x, train=False)
    for variables in (_np_tree(init), _perturb(init, 3)):
        mod = DeformLocConv(4, 5, 3)
        mod.load_state_dict(from_flax_variables(variables), strict=True)
        mod.train(train)
        if train:
            want, _ = jmod.apply(variables, x, train=True,
                                 mutable=["batch_stats"])
        else:
            want = jmod.apply(variables, x, train=False)
        got = _nhwc(mod(_nchw(x)))
        np.testing.assert_allclose(got, np.asarray(want), **SHALLOW)


@pytest.mark.parametrize("same", [True, False])
def test_nlup_matches_jax(same):
    """Cross-resolution attention from a 6x8 query map to a 3x4 value map
    (1x1 key/value convs when the widths differ), eval and train mode."""
    rng = np.random.default_rng(7)
    q = rng.normal(size=(2, 6, 8, 6)).astype(np.float32)
    v = rng.normal(size=(2, 3, 4, 6 if same else 10)).astype(np.float32)
    jmod = JNLUp()
    variables = _perturb(jmod.init(jax.random.PRNGKey(3), q, v, train=False),
                         4)
    mod = NLUp(6, v.shape[-1])
    mod.load_state_dict(from_flax_variables(variables), strict=True)
    for train in (False, True):
        if train:
            want, _ = jmod.apply(variables, q, v, train=True,
                                 mutable=["batch_stats"])
        else:
            want = jmod.apply(variables, q, v, train=False)
        got = _nhwc(mod.train(train)(_nchw(q), _nchw(v)))
        np.testing.assert_allclose(got, np.asarray(want), **SHALLOW)


@pytest.mark.parametrize("residual", [True, False])
def test_nlpm_matches_jax(residual):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 16, 20, 8)).astype(np.float32)
    out = 8 if residual else 5
    jmod = JNLPM(out_features=out, key_features=6, residual=residual)
    variables = _np_tree(jmod.init(jax.random.PRNGKey(4), x))
    mod = NLPM(8, out, 6, residual=residual)
    mod.load_state_dict(from_flax_variables(variables), strict=True)
    np.testing.assert_allclose(_nhwc(mod(_nchw(x))),
                               np.asarray(jmod.apply(variables, x)),
                               **SHALLOW)


# ---------------------------------------------------------------------------
# dla34_depth with every option on: the model and one train step
# ---------------------------------------------------------------------------

def _depth_confs(imdb):
    """The flagship config at 512 x 64 on dla34_depth with every option of
    the slice on; anchors by k-means and whitening stats from the synthetic
    split, shared by both packages."""
    kw = dict(warmup=0.0, box_samples=1.0, **OPTIONS)
    conf = flagship_conf(DEPTH_CROP, num_scales=2, backbone="dla34_depth",
                         dtype="float32").replace(anchors=None, **kw)
    t_anchors.generate_anchors(conf, imdb)
    t_anchors.compute_bbox_stats(conf, imdb)
    jconf = __graft_entry__._flagship_conf(
        DEPTH_CROP, num_scales=2, backbone="dla34_depth",
        dtype="float32").replace(**kw)
    jconf.anchors = conf.anchors.copy()
    jconf.bbox_means = conf.bbox_means.copy()
    jconf.bbox_stds = conf.bbox_stds.copy()
    return jconf, conf


@pytest.fixture(scope="module")
def depth(imdbs):
    """Both confs, the rois, the JAX model's initial variables (one jitted
    init at 512 x 32: parameter shapes do not depend on the width) and one
    train build of the port's model (125 M parameters, most of them in the
    row-banded convs of levels 4 and 5), which each test loads with the
    weights it needs."""
    jconf, conf = _depth_confs(imdbs[3])
    rois = t_anchors.locate_anchors(conf.anchors, conf.feat_size,
                                    conf.feat_stride)
    jmodel = j_build(jconf)
    variables = jax.jit(lambda k, x: jmodel.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, DEPTH_CROP[0], 32, 3)))
    model = build(conf, device="cpu", seed=1, phase="train")
    return jconf, conf, rois, jmodel, variables, model


def test_clustered_anchor_count_reaches_the_model(depth):
    """k-means drops unused anchors: the head, the rois and the loss take
    A from the anchors, whatever it is."""
    _, conf, rois, _, variables, model = depth
    A = conf.anchors.shape[0]
    assert 0 < A <= 6
    assert rois.shape[0] == A * conf.feat_size[0] * conf.feat_size[1]
    assert model.num_anchors == A
    model.load_state_dict(from_flax_variables(_np_tree(variables)),
                          strict=True)


def test_dla34_depth_model_matches_jax(depth):
    """The whole detector (eval mode, perturbed weights) at 512 x 64."""
    jconf, conf, _, jmodel, variables, model = depth
    variables = _perturb(variables, 9)
    model.load_state_dict(from_flax_variables(variables), strict=True)
    model.eval()
    images = np.random.default_rng(10).normal(
        size=(2,) + DEPTH_CROP + (3,)).astype(np.float32)
    jout = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, images)
    with torch.inference_mode():
        out = model(torch.from_numpy(images))
    for k in ("cls_t", "prob_t", "bbox_2d", "bbox_3d"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   err_msg=k, **DEEP)


def _step_batch(N, B=2, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=(B, N))
    fg, ign = u < 0.03, u > 0.9
    labels = np.where(fg, rng.integers(1, 4, size=(B, N)), 0)
    labels = np.where(ign, 3000, labels).astype(np.int32)
    return {"images": rng.normal(size=(B,) + DEPTH_CROP + (3,))
            .astype(np.float32),
            "labels": labels, "labels_fg": fg.astype(np.int8),
            "labels_bg": (~fg & ~ign).astype(np.int8),
            "labels_ign": ign.astype(np.int8),
            "bbox_2d": (rng.normal(size=(B, 4, N)) * 0.5).astype(np.float32),
            "bbox_3d": (rng.normal(size=(B, 7, N)) * 0.5).astype(np.float32),
            "any_val": np.ones(B, np.int32),
            "p2_inv": np.stack([np.linalg.inv(P2)] * B).astype(np.float32)}


def test_train_step_with_every_option_matches_jax(depth):
    """One train step of dla34_depth with k-means anchors and both loss
    branches on, from shared weights, against JAX `make_train_step`:
    loss and stats (the two branches' included) within 1e-4, the updates
    within 3e-2 of the largest and 3e-2 median per tensor, the BN
    statistics within 1e-4 (test_torch_train.py's limits).

    The weights are perturbed off the init: at a fresh init the anchors'
    scores are near-equal (top-two gap down to 8e-7), one position's
    argmax anchor differed between the frameworks, its boxes moved by up
    to 0.93 and the projection loss (box centres in metres) by 2.7e-4."""
    jconf, conf, rois, jmodel, variables, model = depth
    variables = _perturb(variables, 13)
    params, stats = variables["params"], variables["batch_stats"]
    mask_fn = j_freeze_mask_fn(jconf)
    mask = None if mask_fn is None else \
        jax.tree_util.tree_map_with_path(mask_fn, params)
    tx = j_make_optimizer(jconf, 100, trainable_mask=mask)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats=stats, opt_state=tx.init(params), tx=tx,
                         apply_fn=jmodel.apply)
    batch = _step_batch(rois.shape[0])
    jnext, jstats = j_make_train_step(jconf, rois)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(1))
    jstats = {k: float(v) for k, v in jstats.items()}

    model.load_state_dict(from_flax_variables(_np_tree(variables)),
                          strict=True)
    model.train()
    state = create_train_state(conf, model, max_iter=100)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = make_train_step(conf, rois)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(got) == sorted(jstats)
    assert "loss_bbox3d_proj" in got and "loss_bbox3d_iou" in got
    for k, v in jstats.items():
        np.testing.assert_allclose(float(got[k]), v, rtol=STEP_TOL,
                                   atol=1e-6, err_msg=k)

    sd = model.state_dict()
    ref = from_flax_variables({"params": _np_tree(jnext.params),
                               "batch_stats": _np_tree(jnext.batch_stats)})
    names = [n for n, _ in model.named_parameters()]
    upd = {n: ref[n] - before[n] for n in names}
    top = max(float(u.abs().max()) for u in upd.values())
    diff = {n: float((sd[n] - ref[n]).abs().max()) for n in names}
    own = [diff[n] / float(u.abs().max()) for n, u in upd.items()
           if float(u.abs().max()) >= 1e-6 * top]
    assert max(diff.values()) <= UPDATE_TOL * top, (max(diff.values()), top)
    assert np.median(own) <= UPDATE_MEDIAN_TOL, np.median(own)
    for n in ref:
        if n.endswith(("running_mean", "running_var")):
            err = float((sd[n] - ref[n]).abs().max()
                        / ref[n].abs().max().clamp(min=1e-12))
            assert err < STEP_TOL, (n, err)
    # the neck of dla34 has the flagship's 8 shift-DCN layers
    assert sum(isinstance(m, DCN) and m.uses_shift
               for m in model.modules()) == 8


def test_dla34_depth_loads_an_upstream_checkpoint(depth):
    """A checkpoint in the original model's layout loads into a
    dla34_depth build with BasicBlock's names, as the reference package
    maps dla34_depth: every translated entry loads and equals its source;
    the row-banded conv and its BatchNorm have no original name and keep
    the model's values. The port and the reference package translate the
    same keys."""
    _, conf, _, _, _, src = depth
    A, C = conf.anchors.shape[0], conf.num_classes
    assert ti.reference_block("dla34_depth") == "basic"
    assert ti.reference_block("dla102") == "bottleneck"
    sd = reference_state_dict(src, A, C, block="basic")
    dst = copy.deepcopy(src)
    with torch.no_grad():
        for t in dst.state_dict().values():
            if t.is_floating_point():
                t.add_(1.0)
    new, stats = ti.load_reference_checkpoint(
        dst, sd, num_anchors=A, num_classes=C,
        block=ti.reference_block(conf.back_bone))
    assert stats["loaded"] == len(sd)
    assert not stats["missing"] and not stats["shape_mismatch"]
    assert any("LocalConv2d_0" in u for u in stats["unmapped"])
    dst.load_state_dict(new, strict=True)
    want, kept = src.state_dict(), dst.state_dict()
    modules = dict(src.named_modules())
    for key in want:
        if key.endswith("num_batches_tracked"):
            continue
        parts, leaf = ti.flax_path(modules, key)
        try:
            ref_key = j_torch_import.flax_to_torch_key(
                parts, leaf, num_anchors=A, num_classes=C, block="basic")[0]
        except (KeyError, AttributeError, IndexError, TypeError):
            ref_key = None
        assert (ref_key in sd) == (ref_key is not None), key
        if ref_key is not None:
            assert torch.equal(kept[key], want[key]), key


# ---------------------------------------------------------------------------
# val_train, poses, the eval loader and the test CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("val_train"))
    j_generate(root, num_train=3, num_val=1, seed=5, imW=224, imH=64,
               min_h_px=6)
    kw = dict(crop_size=[64, 224], test_scale=[64, 224], num_anchor_scales=2,
              back_bone="dla34", pre_train=False, compute_dtype="float32",
              batch_size=2, num_workers=2, eval_batch_size=2)
    return root, j_conf_fn().replace(**kw), kitti_3d_anab_fullalign() \
        .replace(**kw)


def test_val_train_samples_match_jax(split):
    """val_train: the train split's images and imdb (labels read) with the
    eval preprocessing, equal to the JAX dataset's samples; EvalLoader
    yields them in order."""
    root, jconf, conf = split
    jtrain = j_kitti.Kitti3DDataset(jconf, root, phase="train")
    conf.anchors, conf.bbox_means, conf.bbox_stds = (
        jtrain.conf.anchors, jtrain.conf.bbox_means, jtrain.conf.bbox_stds)
    jds = j_kitti.Kitti3DDataset(jconf, root, phase="val_train")
    ds = t_kitti.Kitti3DDataset(conf, root, phase="val_train")
    assert ds.rois is None and len(ds) == len(jds) == 3
    assert all(o.gts for o in ds.imdb)
    for i, s in enumerate(EvalLoader(ds)):
        want = jds[i]
        np.testing.assert_array_equal(s["input"], want["input"])
        for k in ("p2", "p2_inv", "imH", "imW", "scale_factor", "id"):
            np.testing.assert_array_equal(s["meta"][k], want["meta"][k])
    assert i == 2


def test_read_kitti_poses_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    rows = [" ".join(f"{v:.6e}" for v in rng.normal(size=12))
            for _ in range(3)]
    path = tmp_path / "poses.txt"
    path.write_text("\n".join(rows[:2] + ["1 2 3", "a b c d e f g h i j k l"]
                              + rows[2:]) + "\n")
    got = t_kitti.read_kitti_poses(str(path))
    want = j_kitti.read_kitti_poses(str(path))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_test_cli_val_train_phase(split, tmp_path, capsys):
    """`--phase val_train --cpu` evaluates a run's checkpoint on the train
    split, with the train labels as ground truth."""
    root, _, conf = split
    ds = t_kitti.Kitti3DDataset(conf.replace(anchors=None), root,
                                phase="train")
    run = str(tmp_path / "run")
    os.makedirs(run)
    ds.conf.save(os.path.join(run, "conf.pkl"))
    model = build(ds.conf, device="cpu", seed=0)
    save_checkpoint(os.path.join(run, "weights"),
                    create_train_state(ds.conf, model, 10), 3)
    test_cli.main(["--run_dir", run, "--data_root", root, "--phase",
                   "val_train", "--cpu", "--no_src_snapshot"])
    out = capsys.readouterr().out
    assert "selection metric" in out
    txts = sorted(os.listdir(os.path.join(run, "results", "results_test_3",
                                          "data")))
    assert txts == [f"{i:06d}.txt" for i in range(3)]


# ---------------------------------------------------------------------------
# profiling helpers and the Trainer's TensorBoard writer
# ---------------------------------------------------------------------------

def _tiny(**kw):
    return kitti_3d_anab_fullalign().replace(
        crop_size=[64, 224], test_scale=[64, 224], num_anchor_scales=2,
        back_bone="dla34", compute_dtype="float32", pre_train=False,
        batch_size=2, num_workers=2, eval_batch_size=2, display_iter=1,
        **kw)


def test_trainer_writes_tensorboard_scalars(tmp_path):
    """Rank 0's writer takes the StatTracker's Train/ scalars and the
    eval's Test/{key}/{easy,moderate,hard} scalars."""
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator

    conf = _tiny(max_epoch=1, do_test=True, eval_epoch=1)
    ds = SyntheticTrainSet(conf, 4, seed=3, imW=224, imH=64, min_h_px=6)
    tr = Trainer(conf, None, str(tmp_path / "out"), device="cpu", dataset=ds,
                 val_dataset=SyntheticEvalSet(conf, 4, seed=4, imW=224,
                                              imH=64, min_h_px=6))
    assert tr.writer is not None
    tr.run(1)
    tr.writer.close()
    acc = EventAccumulator(str(tmp_path / "out" / "log" / "tb"))
    acc.Reload()
    tags = acc.Tags()["scalars"]
    assert "Train/loss" in tags
    for d in ("easy", "moderate", "hard"):
        assert f"Test/Car_3d_R40/{d}" in tags
    assert len(acc.Scalars("Train/loss")) == tr.steps_per_epoch


def test_make_tb_writer_is_none_without_tensorboard(tmp_path, monkeypatch,
                                                    caplog):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with caplog.at_level(logging.WARNING):
        assert profiling.make_tb_writer(str(tmp_path / "tb")) is None
    assert "tensorboard writer unavailable" in caplog.text


def test_phase_timer_and_device_trace(tmp_path):
    """`device_trace` holds the program's own spans (the phase timer's
    host clock gave way to them): greedy NMS's rounds, and no sync, in
    `key_averages()` and in the Chrome trace it writes."""
    from m3dssd_tpu_torch.ops.nms import nms_select_t

    boxes = torch.tensor([[0.0, 0.0, 9.0, 9.0], [1.0, 1.0, 10.0, 10.0],
                          [20.0, 20.0, 29.0, 29.0]]).T
    scores = torch.tensor([0.9, 0.8, 0.7])
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        idx, valid = nms_select_t(boxes, scores, 0.4, 3)
    assert idx.tolist()[:2] == [0, 2] and valid.tolist() == [True, True,
                                                              False]
    counted = {e.key: e.count for e in prof.key_averages()}
    assert counted["m3dssd.nms.round"] == 3
    assert not [k for k in counted if k.startswith("m3dssd.sync.")]
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "trace" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    rounds = [e for e in events if e.get("name") == "m3dssd.nms.round"]
    assert len(rounds) == 3 and all(e["cat"] == "user_annotation"
                                    for e in rounds)

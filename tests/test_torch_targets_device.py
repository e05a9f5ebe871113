"""The port's on-device anchor target assignment against the JAX package's:
`compute_targets_device` on random scenes (with padding, without gts,
with ignore boxes) and on a synthetic split against the port's host
`build_targets`, `build_gt_arrays` against JAX's, and one and two whole
train steps with `pre_compute_target=False` against JAX `make_train_step`
under the criteria of tests/test_torch_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from m3dssd_tpu.anchors import locate_anchors as j_locate_anchors
from m3dssd_tpu.models import build as j_build
from m3dssd_tpu.ops.targets_device import \
    compute_targets_device as j_compute_targets_device
from m3dssd_tpu.targets import build_gt_arrays as j_build_gt_arrays
from m3dssd_tpu.train.state import create_train_state as j_create_train_state
from m3dssd_tpu.train.state import make_train_step as j_make_train_step
from m3dssd_tpu_torch.anchors import locate_anchors
from m3dssd_tpu_torch.config import flagship_conf
from m3dssd_tpu_torch.data.loader import TrainLoader
from m3dssd_tpu_torch.data.synthetic import SyntheticTrainSet
from m3dssd_tpu_torch.models import build
from m3dssd_tpu_torch.ops.targets_device import (IGN_FLAG,
                                                 compute_targets_device,
                                                 make_device_target_fn)
from m3dssd_tpu_torch.targets import build_gt_arrays, build_targets
from m3dssd_tpu_torch.train.state import create_train_state, make_train_step
from m3dssd_tpu_torch.utils.weights import (from_flax_variables,
                                            sgd_state_from_optax)

# one torch thread per test process (see tests/test_torch_train.py)
torch.set_num_threads(1)

CROP = (64, 128)
SPLIT_CROP = (64, 224)   # the synthetic split's images (objects tall enough)
TARGET_TOL = 1e-5        # regression targets, relative to the largest
STEP_TOL = 1e-4          # loss, stats, BN statistics (relative)
UPDATE_TOL = 3e-2        # parameter updates, relative to the largest one
UPDATE_MEDIAN_TOL = 3e-2  # median over tensors, each against its own
KEYS = ("labels", "labels_fg", "labels_bg", "labels_ign", "bbox_2d",
        "bbox_3d", "any_val")


def _random_scene(rng, A=4, H=6, W=8, G=3, n_ign=1):
    """The scenes of tests/test_targets_device.py."""
    anchors = np.concatenate([
        np.stack([rng.uniform(-30, -10, A), rng.uniform(-30, -10, A),
                  rng.uniform(10, 30, A), rng.uniform(10, 30, A)], axis=1),
        np.abs(rng.normal(20, 3, [A, 1])),
        np.abs(rng.normal(2, .2, [A, 3])),
        rng.uniform(-1, 1, [A, 1])], axis=1)
    rois = locate_anchors(anchors, [H, W], 8)
    cx = rng.uniform(0, W * 8, G)
    cy = rng.uniform(0, H * 8, G)
    w = rng.uniform(15, 50, G)
    h = rng.uniform(15, 50, G)
    gts_val = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], 1)
    gts_3d = np.concatenate([
        cx[:, None], cy[:, None], rng.uniform(10, 40, [G, 1]),
        np.abs(rng.normal(2, .3, [G, 3])), rng.uniform(-1, 1, [G, 1]),
        rng.normal(size=(G, 4))], axis=1)
    box_lbls = rng.integers(1, 4, G)
    icx = rng.uniform(0, W * 8, n_ign)
    icy = rng.uniform(0, H * 8, n_ign)
    gts_ign = np.stack([icx - 20, icy - 20, icx + 20, icy + 20], axis=1)
    return anchors, rois, gts_val, gts_3d, box_lbls, gts_ign


def _padded(gts_val, gts_3d, box_lbls, gts_ign, G, valid=True,
            ign_valid=True, bogus=False):
    """One image's gts padded to G; `bogus` fills the padding with large
    boxes that only their invalid flags keep out."""
    n, ni = gts_val.shape[0], gts_ign.shape[0]
    g = {"gt_boxes2d": np.zeros([G, 4], np.float32),
         "gt_boxes3d": np.zeros([G, 11], np.float32),
         "gt_cls": np.zeros([G], np.int32), "gt_valid": np.zeros([G], np.int8),
         "ign_boxes": np.zeros([G, 4], np.float32),
         "ign_valid": np.zeros([G], np.int8)}
    if bogus:
        g["gt_boxes2d"][:] = [0, 0, 1000, 1000]
        g["gt_boxes3d"][:] = 5.0
        g["gt_cls"][:] = 1
        g["ign_boxes"][:] = [0, 0, 1000, 1000]
    g["gt_boxes2d"][:n] = gts_val
    g["gt_boxes3d"][:n] = gts_3d
    g["gt_cls"][:n] = box_lbls
    g["gt_valid"][:n] = int(valid)
    g["ign_boxes"][:ni] = gts_ign
    g["ign_valid"][:ni] = int(ign_valid)
    return g


def _jax_targets(rois, anchors, means, stds, gts):
    fn = jax.vmap(lambda a, b, c, d, e, f: j_compute_targets_device(
        rois, anchors, means, stds, a, b, c, d, e, f))
    out = fn(*(jnp.asarray(gts[k]) for k in (
        "gt_boxes2d", "gt_boxes3d", "gt_cls", "gt_valid", "ign_boxes",
        "ign_valid")))
    return {k: np.asarray(v) for k, v in out.items()}


def _port_targets(rois, anchors, means, stds, gts):
    out = compute_targets_device(
        torch.as_tensor(rois), torch.as_tensor(anchors),
        torch.as_tensor(means), torch.as_tensor(stds),
        *(torch.from_numpy(gts[k]) for k in (
            "gt_boxes2d", "gt_boxes3d", "gt_cls", "gt_valid", "ign_boxes",
            "ign_valid")))
    return {k: v.numpy() for k, v in out.items()}


def _assert_targets_equal(got, want, fg_only=False):
    """Labels, masks and any_val exactly (with dtypes); the regression
    targets within TARGET_TOL of the largest magnitude, on the fg rois
    only with `fg_only` (the host whitens every roi's zero target, the
    device path zeroes the targets of all but fg)."""
    assert sorted(got) == sorted(KEYS)
    for k in ("labels", "labels_fg", "labels_bg", "labels_ign", "any_val"):
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    fg = got["labels_fg"].astype(bool)[..., None, :]
    for k in ("bbox_2d", "bbox_3d"):
        assert got[k].dtype == np.float32
        g, w = got[k], np.asarray(want[k], np.float32)
        if fg_only:
            g, w = np.where(fg, g, 0.0), np.where(fg, w, 0.0)
        scale = max(float(np.abs(w).max()), 1e-6)
        assert np.abs(g - w).max() <= TARGET_TOL * scale, k


def _scene_batch(seeds, G=6, **kw):
    """Padded gts of the scenes of `seeds` (sharing the first scene's
    anchors), with random whitening stats."""
    rng = np.random.default_rng(seeds[0])
    anchors, rois = _random_scene(rng)[:2]
    gts = []
    for i, s in enumerate(seeds):
        _, _, gv, g3, lb, gi = _random_scene(np.random.default_rng(s))
        gts.append(_padded(gv, g3, lb, gi, G, **(kw if i else {})))
    stacked = {k: np.stack([g[k] for g in gts]) for k in gts[0]}
    r = np.random.default_rng(99)
    means = r.normal(0, 0.1, [1, 11]).astype(np.float32)
    stds = r.uniform(0.5, 2.0, [1, 11]).astype(np.float32)
    return (rois.astype(np.float32), anchors.astype(np.float32), means,
            stds, stacked)


@pytest.mark.parametrize("case", [
    dict(seeds=(0, 1, 2, 3)),
    dict(seeds=(5, 5), bogus=True),                  # with padding
    dict(seeds=(6, 6), valid=False),                 # no gts, ignore boxes
    dict(seeds=(6, 7), valid=False, ign_valid=False),  # no gts at all
    dict(seeds=(1, 2), n_ign=3),                     # more ignore boxes
], ids=["scenes", "padding", "no-gts-ign", "no-gts", "ignores"])
def test_matches_jax(case):
    case = dict(case)
    seeds = case.pop("seeds")
    n_ign = case.pop("n_ign", 1)
    if n_ign != 1:
        rng = np.random.default_rng(seeds[0])
        anchors, rois, gv, g3, lb, gi = _random_scene(rng, n_ign=n_ign)
        gts = {k: v[None] for k, v in _padded(gv, g3, lb, gi, 6).items()}
        means, stds = np.zeros([1, 11], np.float32), \
            np.ones([1, 11], np.float32)
        rois, anchors = rois.astype(np.float32), anchors.astype(np.float32)
    else:
        rois, anchors, means, stds, gts = _scene_batch(seeds, **case)
    want = _jax_targets(rois, anchors, means, stds, gts)
    got = _port_targets(rois, anchors, means, stds, gts)
    _assert_targets_equal(got, want)
    if case.get("valid") is False:
        assert not got["labels_fg"].any(1)[1:].any()
        assert (got["any_val"][1:] == 0).all()
        ign = bool(case.get("ign_valid", True))
        # with ignore boxes the reference's device path ignores every roi
        assert (got["labels"][1:] == (IGN_FLAG if ign else 0)).all()


def test_forcing_of_one_roi_by_several_gts():
    """Two gts whose best roi is the same roi force it once, OR-ed: a
    last-write-wins scatter would let the second gt's False undo the
    first's True."""
    anchors = np.array([[-8, -8, 8, 8, 20, 2, 2, 2, 0]], np.float32)
    rois = locate_anchors(anchors, [2, 2], 8).astype(np.float32)
    gts = _padded(np.array([[-4, -4, 10, 10], [-7, -7, 9, 9]], np.float32),
                  np.ones([2, 11], np.float32), np.array([1, 2]),
                  np.zeros([0, 4], np.float32), 4)
    # the second gt is below best_thresh on every roi but its best roi is
    # the first gt's: the forcing must survive its False
    gts["gt_boxes2d"][1] = [-30, -30, 40, 40]
    gts = {k: v[None] for k, v in gts.items()}
    means, stds = np.zeros([1, 11], np.float32), np.ones([1, 11], np.float32)
    want = _jax_targets(rois, anchors, means, stds, gts)
    got = _port_targets(rois, anchors, means, stds, gts)
    _assert_targets_equal(got, want)
    assert got["labels_fg"].sum() >= 1


def test_single_image_form():
    rois, anchors, means, stds, gts = _scene_batch((0, 1))
    t = {k: torch.from_numpy(v) for k, v in gts.items()}
    keys = ("gt_boxes2d", "gt_boxes3d", "gt_cls", "gt_valid", "ign_boxes",
            "ign_valid")
    both = compute_targets_device(rois, anchors, means, stds,
                                  *(t[k] for k in keys))
    one = compute_targets_device(rois, anchors, means, stds,
                                 *(t[k][1] for k in keys))
    for k in KEYS:
        assert torch.equal(both[k][1], one[k]), k


@pytest.fixture(scope="module")
def tiny():
    conf = flagship_conf(SPLIT_CROP, num_scales=2, backbone="dla34",
                         dtype="float32").replace(
        anchors=None, bbox_means=None, bbox_stds=None)
    ds = SyntheticTrainSet(conf, 6, seed=3, imW=SPLIT_CROP[1],
                           imH=SPLIT_CROP[0], min_h_px=6)
    return conf, ds


def test_matches_the_host_targets(tiny):
    """On a synthetic split: the device assignment of each image's padded
    gts against the port's host build_targets of the same image."""
    conf, ds = tiny
    n_fg = 0
    for imobj in ds.imdb:
        host = build_targets(conf, imobj, rois=ds.rois)
        g = build_gt_arrays(conf, imobj)
        dev = compute_targets_device(
            ds.rois, conf.anchors, conf.bbox_means, conf.bbox_stds,
            *(torch.from_numpy(g[k]) for k in (
                "gt_boxes2d", "gt_boxes3d", "gt_cls", "gt_valid",
                "ign_boxes", "ign_valid")),
            fg_thresh=conf.fg_thresh, ign_thresh=conf.ign_thresh,
            bg_thresh_lo=conf.bg_thresh_lo, bg_thresh_hi=conf.bg_thresh_hi,
            best_thresh=conf.best_thresh)
        dev = {k: v.numpy() for k, v in dev.items()}
        want = dict(host, bbox_2d=host["bbox_2d"].T,
                    bbox_3d=host["bbox_3d"].T,
                    any_val=np.asarray(host["any_val"]))
        dev["any_val"] = dev["any_val"].reshape(())
        _assert_targets_equal(dev, want, fg_only=True)
        n_fg += int(host["labels_fg"].sum())
    assert n_fg > 0


def test_build_gt_arrays_matches_jax(tiny):
    conf, ds = tiny
    jconf = __graft_entry__._flagship_conf(SPLIT_CROP, num_scales=2,
                                           backbone="dla34", dtype="float32")
    for imobj in ds.imdb:
        for g_max in (None, 1):
            got = build_gt_arrays(conf, imobj, g_max)
            want = j_build_gt_arrays(jconf, imobj, g_max)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_loader_ships_padded_gts(tiny):
    conf, ds = tiny
    ds.conf = conf.replace(pre_compute_target=False)
    try:
        batch = next(TrainLoader(ds, 2, num_workers=1, pin=False,
                                 upload_bf16=False).batches(1))
    finally:
        ds.conf = conf
    G = conf.max_gts
    assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()
            if k not in ("images", "p2_inv")} == {
        "gt_boxes2d": ((2, G, 4), torch.float32),
        "gt_boxes3d": ((2, G, 11), torch.float32),
        "gt_cls": ((2, G), torch.int32), "gt_valid": ((2, G), torch.int8),
        "ign_boxes": ((2, G, 4), torch.float32),
        "ign_valid": ((2, G), torch.int8)}
    fn = make_device_target_fn(conf, ds.rois)
    t = fn(batch)
    assert tuple(t["bbox_3d"].shape) == (2, 7, ds.rois.shape[0])


# ---------------------------------------------------------------------------
# whole train steps with pre_compute_target=False
# ---------------------------------------------------------------------------

def _gt_batch(jconf, B=2, seed=0):
    """Images and padded gts in the crop: conf.max_gts cars per image, one
    ignore box in the first.

    The gts fill the padded budget so that the step sees some 40 fg
    anchors, the share the step criteria were set on (the random labels of
    tests/test_torch_train.py). With 3 or 8 cars per image (4 or 9 fg
    anchors) the fg weight bg_total / fg_total concentrates the gradient
    on those few anchors, and JAX's float32 step itself then lies 3.5% of
    the largest update from the port's float64 step (the port's float32
    step 1.0%; ROADMAP section 3).
    """
    rng = np.random.default_rng(seed)
    G = n = jconf.max_gts
    H, W = CROP
    out = {"images": rng.normal(size=(B,) + CROP + (3,)).astype(np.float32)}
    gts = []
    for b in range(B):
        cx, cy = rng.uniform(16, W - 16, n), rng.uniform(12, H - 12, n)
        w, h = rng.uniform(12, 40, n), rng.uniform(10, 30, n)
        box = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], 1)
        g3 = np.concatenate([cx[:, None], cy[:, None],
                             rng.uniform(10, 40, [n, 1]),
                             np.abs(rng.normal(1.6, .2, [n, 3])),
                             rng.uniform(-3, 3, [n, 1]),
                             rng.normal(size=(n, 4))], 1)
        ign = box[:1] + 5.0 if b == 0 else np.zeros([0, 4])
        gts.append(_padded(box.astype(np.float32), g3.astype(np.float32),
                           np.ones(n, np.int32), ign.astype(np.float32), G))
    out.update({k: np.stack([g[k] for g in gts]) for k in gts[0]})
    return out


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ref(jstate):
    return from_flax_variables({"params": _np(jstate.params),
                                "batch_stats": _np(jstate.batch_stats)})


def _check_stats(sd, ref, tol):
    for n in ref:
        if n.endswith(("running_mean", "running_var")):
            err = float((sd[n] - ref[n]).abs().max()
                        / ref[n].abs().max().clamp(min=1e-12))
            assert err < tol, (n, err)


def _check_step(state, jstate, before):
    """The step's updates against JAX's (median over tensors of each
    against its own largest JAX update, and the largest difference against
    the largest update), then the BN statistics."""
    sd = state.model.state_dict()
    ref = _ref(jstate)
    names = [n for n, _ in state.model.named_parameters()]
    upd = {n: ref[n] - before[n] for n in names}
    top = max(float(u.abs().max()) for u in upd.values())
    diff = {n: float((sd[n] - ref[n]).abs().max()) for n in names}
    own = [diff[n] / float(u.abs().max()) for n, u in upd.items()
           if float(u.abs().max()) >= 1e-6 * top]
    assert max(diff.values()) <= UPDATE_TOL * top, (max(diff.values()), top)
    assert np.median(own) <= UPDATE_MEDIAN_TOL, np.median(own)
    _check_stats(sd, ref, STEP_TOL)


def test_one_and_two_train_steps_match_jax():
    """Targets assigned inside the step, on one batch of padded gts: step
    1 from shared initial weights, and step 2 from JAX's state after step
    1 (weights, BN statistics and the SGD momentum trace), each against
    JAX's step (loss and stats, the updates and the BN statistics). Step
    2 starts from one shared state rather than from each framework's own
    step 1: in this regime float32 noise of step 1 alone moves step 2's
    iou stat by 2% of itself."""
    jconf = __graft_entry__._flagship_conf(
        CROP, num_scales=2, backbone="dla34", dtype="float32").replace(
        warmup=0.0, box_samples=1.0, pre_compute_target=False)
    conf = flagship_conf(CROP, num_scales=2, backbone="dla34",
                         dtype="float32").replace(
        warmup=0.0, box_samples=1.0, pre_compute_target=False)
    rois = j_locate_anchors(jconf.anchors, jconf.feat_size, jconf.feat_stride)
    batch = _gt_batch(jconf)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    assert int(make_device_target_fn(conf, rois)(tb)["labels_fg"].sum()) > 0
    jstate = j_create_train_state(jconf, j_build(jconf),
                                  jax.random.PRNGKey(0), max_iter=100)
    jstep = j_make_train_step(jconf, rois)
    jstates, jstats = [jstate], []
    for _ in range(2):
        jstate, s = jstep(jstate, {k: jnp.asarray(v)
                                   for k, v in batch.items()},
                          jax.random.PRNGKey(1))
        jstates.append(jstate)
        jstats.append({k: float(v) for k, v in s.items()})

    step = make_train_step(conf, rois)
    for i in range(2):
        model = build(conf, device="cpu", phase="train")
        model.load_state_dict(_ref(jstates[i]), strict=True)
        state = create_train_state(conf, model, max_iter=100)
        if i:
            trace = jstates[i].opt_state[1][0].trace
            state.optimizer.load_state_dict(sgd_state_from_optax(_np(trace),
                                                                 i))
            state.step = i
        before = {k: v.clone() for k, v in model.state_dict().items()}
        stats = step(state, tb)
        assert state.step == i + 1
        assert sorted(stats) == sorted(jstats[i])
        for k, v in jstats[i].items():
            np.testing.assert_allclose(float(stats[k]), v, rtol=STEP_TOL,
                                       atol=1e-6, err_msg=f"{k} step {i}")
        _check_step(state, jstates[i + 1], before)


def test_device_target_step_equals_the_precomputed_step():
    """A step that assigns its targets on the device takes the same
    update, bit for bit, as a step given those targets in the batch."""
    conf = flagship_conf(CROP, num_scales=2, backbone="dla34",
                         dtype="float32").replace(warmup=0.0,
                                                  pre_compute_target=False)
    rois = locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    batch = {k: torch.from_numpy(v) for k, v in _gt_batch(conf).items()}
    pre = {k: v for k, v in batch.items() if k in ("images", "p2_inv")}
    pre.update(make_device_target_fn(conf, rois)(batch))
    sds = []
    for c, b in ((conf, batch), (conf.replace(pre_compute_target=True),
                                 pre)):
        state = create_train_state(c, build(c, device="cpu", seed=2,
                                            phase="train"), max_iter=100)
        stats = make_train_step(c, rois)(state, b)
        sds.append((state.model.state_dict(),
                    {k: float(v) for k, v in stats.items()}))
    (a, sa), (b, sb) = sds
    assert sa == sb
    assert all(torch.equal(a[k], b[k]) for k in a)

"""The port's detection loss against the JAX package's, on identical model
outputs made from a numpy seed.

The loss is tested on its own here: both sides take the same output
tensors, so hard mining sees the same scores (the whole-step tests feed
each framework its own model's outputs, where float32 noise can move an
anchor across a mining budget's edge).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from m3dssd_tpu.anchors import locate_anchors as j_locate_anchors
from m3dssd_tpu.losses.rpn_loss import RPNLossConfig as JCfg
from m3dssd_tpu.losses.rpn_loss import _rank_select_pools as j_rank_select
from m3dssd_tpu.losses.rpn_loss import rpn_3d_loss as j_rpn_3d_loss
from m3dssd_tpu_torch.losses.rpn_loss import (RPNLossConfig,
                                              rank_select_pools,
                                              rpn_3d_loss)

# one torch thread per test process: the suite runs several workers at
# once, and torch's default of one thread per core made them
# oversubscribe the machine and slow every worker down
torch.set_num_threads(1)

CROP = (64, 128)
B = 2
# float32 sums over a few thousand anchors in another order
TOL = dict(rtol=2e-5, atol=1e-6)


@pytest.fixture(scope="module")
def setup():
    conf = __graft_entry__._flagship_conf(CROP, num_scales=2,
                                          backbone="dla34", dtype="float32")
    rois = j_locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    return conf, rois


def _outputs(seed, N, C=4, tie_grid=None):
    rng = np.random.default_rng(seed)
    cls_t = (rng.normal(size=(B, C, N)) * 2).astype(np.float32)
    e = np.exp(cls_t - cls_t.max(1, keepdims=True))
    prob_t = (e / e.sum(1, keepdims=True)).astype(np.float32)
    if tie_grid:
        # many exactly equal scores: mining has ties at its budget edges
        prob_t = (np.round(prob_t * tie_grid) / tie_grid).astype(np.float32)
    lse = (np.log(np.exp(cls_t.astype(np.float64)).sum(1))).astype(
        np.float32)
    return {"cls_t": cls_t, "prob_t": prob_t, "lse": lse,
            "bbox_2d": (rng.normal(size=(B, 4, N)) * 0.5).astype(np.float32),
            "bbox_3d": (rng.normal(size=(B, 7, N)) * 0.8).astype(np.float32)}


def _batch(seed, N, fg=0.03, ign=0.1, empty_image=False):
    rng = np.random.default_rng(seed + 100)
    u = rng.uniform(size=(B, N))
    is_fg, is_ign = u < fg, u > 1 - ign
    if empty_image:
        is_fg[1], is_ign[1] = False, False
    is_bg = ~is_fg & ~is_ign
    labels = np.where(is_fg, rng.integers(1, 4, size=(B, N)), 0)
    labels = np.where(is_ign, 3000, labels).astype(np.int32)
    return {"labels": labels, "labels_fg": is_fg.astype(np.int8),
            "labels_bg": is_bg.astype(np.int8),
            "labels_ign": is_ign.astype(np.int8),
            "bbox_2d": (rng.normal(size=(B, 4, N)) * 0.5).astype(np.float32),
            "bbox_3d": (rng.normal(size=(B, 7, N)) * 0.5).astype(np.float32),
            "any_val": np.array([1, 0 if empty_image else 1], np.int32)}


def _run_both(conf, rois, outputs, batch, **cfg):
    jcfg = JCfg.from_conf(conf).__class__(
        **{**JCfg.from_conf(conf).__dict__, **cfg})
    consts = (rois[:, :5].astype(np.float32),
              np.asarray(conf.anchors, np.float32),
              np.asarray(conf.bbox_means, np.float32),
              np.asarray(conf.bbox_stds, np.float32))
    jl, js = j_rpn_3d_loss({k: jnp.asarray(v) for k, v in outputs.items()},
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           *[jnp.asarray(c) for c in consts], jcfg)
    tcfg = RPNLossConfig(**{k: v for k, v in jcfg.__dict__.items()
                            if k != "channel_major"})
    tl, ts = rpn_3d_loss({k: torch.from_numpy(v) for k, v in outputs.items()},
                         {k: torch.from_numpy(v) for k, v in batch.items()},
                         *[torch.from_numpy(c) for c in consts], tcfg)
    return (float(jl), {k: float(v) for k, v in js.items()}), \
        (float(tl), {k: float(v) for k, v in ts.items()})


@pytest.mark.parametrize("light_stats", [False, True])
@pytest.mark.parametrize("mining_bisect", [False, True])
@pytest.mark.parametrize("tie_grid", [None, 16])
def test_loss_and_stats_match_jax(setup, light_stats, mining_bisect,
                                  tie_grid):
    """Loss and every stats key, with the reference mining by its sort and
    by its bisection (the port always sorts), with and without score ties,
    and with an image that has no ground truth."""
    conf, rois = setup
    N = rois.shape[0]
    outputs = _outputs(1, N, tie_grid=tie_grid)
    batch = _batch(2, N, empty_image=True)
    (jl, js), (tl, ts) = _run_both(conf, rois, outputs, batch,
                                   light_stats=light_stats,
                                   mining_bisect=mining_bisect)
    assert sorted(js) == sorted(ts)
    np.testing.assert_allclose(tl, jl, **TOL)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], err_msg=k, **TOL)
    assert ts["fg_count"] > 0 and ts["bg_count"] > 0


@pytest.mark.parametrize("focal,bbox2d", [(0.0, 0.0), (2.0, 1.0)])
def test_loss_gradients_match_jax(setup, focal, bbox2d):
    """d loss / d (cls_t, lse, bbox_2d, bbox_3d) against jax.grad, with
    prob_t held constant as both losses stop its gradient; also with the
    focal down-weighting and the 2D SmoothL1 branch on."""
    conf, rois = setup
    N = rois.shape[0]
    outputs = _outputs(3, N)
    batch = _batch(4, N)
    jcfg = JCfg.from_conf(conf).__class__(
        **{**JCfg.from_conf(conf).__dict__, "focal_loss": focal,
           "bbox_2d_lambda": bbox2d})
    consts = (rois[:, :5].astype(np.float32),
              np.asarray(conf.anchors, np.float32),
              np.asarray(conf.bbox_means, np.float32),
              np.asarray(conf.bbox_stds, np.float32))
    keys = ("cls_t", "lse", "bbox_2d", "bbox_3d")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jf(*vals):
        out = dict(outputs, **dict(zip(keys, vals)))
        out["prob_t"] = jnp.asarray(outputs["prob_t"])
        return j_rpn_3d_loss(out, jb, *[jnp.asarray(c) for c in consts],
                             jcfg)[0]

    want = jax.grad(jf, argnums=(0, 1, 2, 3))(
        *[jnp.asarray(outputs[k]) for k in keys])
    ts = {k: torch.tensor(outputs[k], requires_grad=True) for k in keys}
    tout = dict(ts, prob_t=torch.from_numpy(outputs["prob_t"]))
    tcfg = RPNLossConfig(**{k: v for k, v in jcfg.__dict__.items()
                            if k != "channel_major"})
    loss, _ = rpn_3d_loss(tout, {k: torch.from_numpy(v)
                                 for k, v in batch.items()},
                          *[torch.from_numpy(c) for c in consts], tcfg)
    loss.backward()
    for k, w in zip(keys, want):
        w = np.asarray(w)
        scale = max(np.abs(w).max(), 1e-12)
        assert np.abs(ts[k].grad.numpy() - w).max() / scale < 1e-5, k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rank_select_matches_jax_on_ties_and_budget_edges(seed):
    """The stable-sort selection against the reference's, with scores on a
    coarse grid (many ties at the threshold), budgets of 0, exact pool
    size, above it and mid-tie, and an empty pool."""
    rng = np.random.default_rng(seed)
    Bn, N = 4, 300
    score = (rng.integers(0, 6, size=(Bn, N)) / 5.0).astype(np.float32)
    score[0, :5] = -0.0                    # signed zeros tie with +0.0
    pools = [rng.uniform(size=(Bn, N)) < 0.3,
             rng.uniform(size=(Bn, N)) < 0.6]
    pools[0][3] = False                    # an empty pool
    sizes = [p.sum(1) for p in pools]
    budgets = [np.array([0, s[1], s[2] + 5, 17], np.int32) for s in sizes]
    want = j_rank_select(jnp.asarray(score),
                         [jnp.asarray(p) for p in pools],
                         [jnp.asarray(b) for b in budgets])
    got = rank_select_pools(torch.from_numpy(score),
                            [torch.from_numpy(p) for p in pools],
                            [torch.from_numpy(b).long() for b in budgets])
    for g, w, b, s in zip(got, want, budgets, sizes):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy().sum(1), np.minimum(b, s))


def test_random_sampling_and_unported_branches(setup):
    """hard_negatives off draws the sampling scores from a torch.Generator
    (same draw, same loss; the budgets hold); the 3D-projection and 3D-IoU
    branches are not ported and raise."""
    conf, rois = setup
    N = rois.shape[0]
    outputs = {k: torch.from_numpy(v) for k, v in _outputs(5, N).items()}
    batch = {k: torch.from_numpy(v) for k, v in _batch(6, N).items()}
    consts = [torch.from_numpy(np.asarray(c, np.float32)) for c in
              (rois[:, :5], conf.anchors, conf.bbox_means, conf.bbox_stds)]
    cfg = RPNLossConfig.from_conf(conf.replace(hard_negatives=False))
    with pytest.raises(ValueError):
        rpn_3d_loss(outputs, batch, *consts, cfg)
    runs = [rpn_3d_loss(outputs, batch, *consts, cfg,
                        torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert float(runs[0][0]) == float(runs[1][0])
    assert float(runs[0][0]) != float(runs[2][0])
    fg_budget = round(N * cfg.box_samples * cfg.fg_fraction)
    n_fg = batch["labels_fg"].sum(1).clamp(max=fg_budget)
    assert float(runs[0][1]["fg_count"]) == float(n_fg.sum())
    assert float(runs[0][1]["bg_count"]) == float(
        (round(N * cfg.box_samples) - n_fg).sum())
    for key in ("bbox_3d_proj_lambda", "bbox_3d_iou_lambda"):
        bad = RPNLossConfig.from_conf(conf.replace(**{key: 1.0}))
        with pytest.raises(NotImplementedError):
            rpn_3d_loss(outputs, batch, *consts, bad)

"""The port's training path against the JAX package's: learning-rate
schedules, the optimizer against optax, train-mode BatchNorm against
flax, whole train steps of the tiny flagship, checkpoints and the Trainer.

Whole steps. Both frameworks start from one set of weights (DCN offset
convs zero, so every neck offset sits exactly on the triangle kinks) and
take the same batch; JAX runs its `make_train_step` as the package ships
it. The steps run with box_samples = 1, so every labelled anchor is
sampled: hard mining picks the lowest-scoring anchors among near-equal
scores of a fresh model; the mining itself is tested exactly on identical
outputs in tests/test_torch_loss.py. Loss, stats and BN running statistics
agree to float32 noise through a deep network (1e-4). The updated
parameters are compared by their updates, per tensor against the tensor's
own largest update and over all against the largest update in the model.
A whole step is not smooth at the scale of float32 rounding: the align
modules' confidence threshold and argmax anchor, the loss's selections
and the activations' kinks flip under input changes of 1e-6, and a few
tensors' updates move by a tenth of their size when they do
(`profile_train_noise.py`, PERF.md). So the median over tensors is held
per tensor, and the largest difference against the largest update.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import __graft_entry__
from m3dssd_tpu.anchors import locate_anchors as j_locate_anchors
from m3dssd_tpu.config import kitti_3d_anab_fullalign as j_conf_fn
from m3dssd_tpu.models import build as j_build
from m3dssd_tpu.train.lr import make_lr_schedule as j_make_lr_schedule
from m3dssd_tpu.train.state import create_train_state as j_create_train_state
from m3dssd_tpu.train.state import make_optimizer as j_make_optimizer
from m3dssd_tpu.train.state import make_train_step as j_make_train_step
from m3dssd_tpu_torch.config import flagship_conf, kitti_3d_anab_fullalign
from m3dssd_tpu_torch.data.synthetic import SyntheticEvalSet
from m3dssd_tpu_torch.models import build
from m3dssd_tpu_torch.models.layers import batch_norm, leaky_relu
from m3dssd_tpu_torch.train.lr import make_lr_schedule
from m3dssd_tpu_torch.train.state import (Optimizer, create_train_state,
                                          make_train_step)
from m3dssd_tpu_torch.train.trainer import Trainer
from m3dssd_tpu_torch.utils.checkpoint import (latest_step,
                                               restore_checkpoint,
                                               save_checkpoint,
                                               wait_for_saves)
from m3dssd_tpu_torch.utils.weights import (_param_entries,
                                            from_flax_variables,
                                            sgd_state_from_optax)

# one torch thread per test process: the suite runs several workers at
# once, and torch's default of one thread per core made them
# oversubscribe the machine and slow every worker down
torch.set_num_threads(1)

CROP = (64, 128)
STEP_TOL = 1e-4          # loss, stats, BN statistics (relative)
UPDATE_TOL = 3e-2        # parameter updates, relative to the largest one
UPDATE_MEDIAN_TOL = 3e-2  # median over tensors, each against its own
# the second of two steps runs each framework's own first update, which
# differ by the update tolerance: its stats and BN statistics drift by
# about that much (the mid-training test takes step 2 from one state)
CARRY_TOL = 2e-2


# ---------------------------------------------------------------------------
# learning rate and optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy,steps", [("cos", None), ("poly", None),
                                          ("step", [0.3, 0.6, 0.9])])
def test_lr_schedules_match_jax(policy, steps):
    kw = dict(lr=0.004, lr_target=0.004 * 1e-5, lr_policy=policy,
              warmup=0.1, lr_steps=steps)
    max_iter = 200
    want = j_make_lr_schedule(j_conf_fn().replace(**kw), max_iter)
    got = make_lr_schedule(kitti_3d_anab_fullalign().replace(**kw), max_iter)
    for it in (0, 1, 5, 19, 20, 21, 60, 120, 179, 199, 200):
        np.testing.assert_allclose(got(it), float(want(it)), rtol=1e-6,
                                   atol=1e-12, err_msg=f"{policy} {it}")


def _toy(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"weight": rng.normal(size=(3, 4)).astype(np.float32),
                  "bias": rng.normal(size=(4,)).astype(np.float32)},
            "frozen_b": {"weight": rng.normal(size=(5,)).astype(np.float32)}}


def _flat(tree):
    return {f"{m}.{n}": v for m, sub in tree.items() for n, v in sub.items()}


@pytest.mark.parametrize("kw", [
    dict(solver_type="sgd"),
    dict(solver_type="adam"),
    dict(solver_type="adamax"),
    dict(solver_type="sgd", grad_clip_norm=0.5),
    dict(solver_type="sgd", freeze_blacklist=["frozen"]),
    dict(solver_type="adam", batch_skip=2, grad_clip_norm=0.5),
    dict(solver_type="sgd", batch_skip=3, freeze_blacklist=["frozen"]),
], ids=["sgd", "adam", "adamax", "clip", "freeze", "skip2", "skip3-freeze"])
def test_optimizer_matches_optax(kw):
    """Five updates of a toy tree: optax chain (clip, decay, solver,
    multi_transform freezing, MultiSteps) against the port's optimizer."""
    kw = dict(lr=0.01, lr_target=1e-5, warmup=0.1, weight_decay=0.01, **kw)
    jconf = j_conf_fn().replace(**kw)
    tconf = kitti_3d_anab_fullalign().replace(**kw)
    max_iter = 20
    params = _toy(0)
    mask = None
    if kw.get("freeze_blacklist"):
        mask = {m: {n: "frozen" not in m for n in sub}
                for m, sub in params.items()}
    tx = j_make_optimizer(jconf, max_iter, trainable_mask=mask)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tp = {k: torch.tensor(v) for k, v in _flat(params).items()}
    trainable = (lambda n: "frozen" not in n) if mask else None
    opt = Optimizer(tconf, max_iter, list(tp), trainable)
    for s in range(5):
        grads = _toy(10 + s)
        upd, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray,
                                                          grads),
                                   opt_state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        opt.step(tp, {k: torch.tensor(v) for k, v in _flat(grads).items()})
        for k, v in _flat(jax.tree_util.tree_map(np.asarray, jp)).items():
            np.testing.assert_allclose(tp[k].numpy(), v, rtol=2e-6,
                                       atol=2e-7, err_msg=f"{k} step {s}")
    if mask:
        np.testing.assert_array_equal(tp["frozen_b.weight"].numpy(),
                                      params["frozen_b"]["weight"])
        assert "frozen_b.weight" not in opt.state


# ---------------------------------------------------------------------------
# BatchNorm in train mode
# ---------------------------------------------------------------------------

def test_train_mode_batchnorm_matches_flax():
    """Output, input/scale/bias gradients and running statistics (biased
    variance, momentum 0.9) against flax's BatchNorm + leaky_relu; and
    where the activations' mean dwarfs their spread, the port's float32
    gradient stays with its float64 one while flax's loses digits."""
    rng = np.random.default_rng(0)
    for loc, spread, check_jax in ((1.0, 3.0, True), (20.0, 0.05, False)):
        x = (rng.normal(size=(2, 4, 8, 16)) * spread + loc).astype(
            np.float32)
        ct = rng.normal(size=x.shape).astype(np.float32)
        sc = rng.uniform(0.5, 1.5, size=16).astype(np.float32)
        bi = rng.normal(size=16).astype(np.float32)
        stats = {"mean": np.full(16, 0.3, np.float32),
                 "var": np.full(16, 2.0, np.float32)}
        bn = nn.BatchNorm(use_running_average=False, momentum=0.9)

        def f(x, p):
            y, m = bn.apply({"params": p, "batch_stats": stats}, x,
                            mutable=["batch_stats"])
            return jnp.sum(nn.leaky_relu(y, 0.01) * ct), m

        (gx, gp), mut = jax.grad(f, argnums=(0, 1), has_aux=True)(
            x, {"scale": sc, "bias": bi})
        grads = {}
        for dtype in (torch.float32, torch.float64):
            tb = batch_norm(16).to(dtype).train()
            with torch.no_grad():
                tb.weight.copy_(torch.tensor(sc))
                tb.bias.copy_(torch.tensor(bi))
                tb.running_mean.copy_(torch.tensor(stats["mean"]))
                tb.running_var.copy_(torch.tensor(stats["var"]))
            xt = torch.tensor(x.transpose(0, 3, 1, 2), dtype=dtype) \
                .contiguous(memory_format=torch.channels_last) \
                .requires_grad_()
            (leaky_relu(tb(xt)) * torch.tensor(
                ct.transpose(0, 3, 1, 2), dtype=dtype)).sum().backward()
            grads[dtype] = xt.grad.numpy().transpose(0, 2, 3, 1)
            np.testing.assert_allclose(
                tb.running_mean.numpy(), mut["batch_stats"]["mean"],
                rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(
                tb.running_var.numpy(), mut["batch_stats"]["var"],
                rtol=1e-4, atol=1e-6)
            if dtype == torch.float32 and check_jax:
                np.testing.assert_allclose(grads[dtype], gx, rtol=1e-4,
                                           atol=1e-5)
                np.testing.assert_allclose(tb.weight.grad.numpy(),
                                           gp["scale"], rtol=1e-4, atol=1e-5)
                np.testing.assert_allclose(tb.bias.grad.numpy(), gp["bias"],
                                           rtol=1e-4, atol=1e-5)
        scale = np.abs(grads[torch.float64]).max()
        assert np.abs(grads[torch.float32] - grads[torch.float64]).max() \
            < 1e-4 * scale
        if not check_jax:
            assert np.abs(np.asarray(gx) - grads[torch.float64]).max() \
                > 1e-2 * scale


def test_train_mode_batchnorm_on_the_cpu_computes_in_float64():
    """On CPU tensors train mode takes its statistics and normalisation in
    float64. torch's CPU kernel for channels_last inputs (the model's
    layout) sums each channel in float32, in one chain per thread, so its
    results changed with the thread count and missed these limits. Now
    output, gradients and running statistics are float64's rounded once,
    the same bits at 1 and 4 threads."""
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(2, 16, 64, 128)) * 0.5 + 3.0).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    sc = rng.uniform(0.5, 1.5, size=16).astype(np.float32)
    bi = rng.normal(size=16).astype(np.float32)
    runs = {}
    threads = torch.get_num_threads()
    try:
        for dtype, n in ((torch.float64, 1), (torch.float32, 1),
                         (torch.float32, 4)):
            torch.set_num_threads(n)
            tb = batch_norm(16).to(dtype).train()
            with torch.no_grad():
                tb.weight.copy_(torch.tensor(sc))
                tb.bias.copy_(torch.tensor(bi))
            xt = torch.tensor(x, dtype=dtype).contiguous(
                memory_format=torch.channels_last).requires_grad_()
            y = tb(xt)
            (y * torch.tensor(ct, dtype=dtype)).sum().backward()
            runs[dtype, n] = (y.detach(), xt.grad, tb.weight.grad,
                              tb.bias.grad, tb.running_mean, tb.running_var)
    finally:
        torch.set_num_threads(threads)
    one, four = runs[torch.float32, 1], runs[torch.float32, 4]
    assert all(torch.equal(a, b) for a, b in zip(one, four))
    assert one[0].dtype == torch.float32
    for got, want in zip(one, runs[torch.float64, 1]):
        err = float((got.double() - want).abs().max() / want.abs().max())
        assert err < 2e-7, err


# ---------------------------------------------------------------------------
# whole train steps
# ---------------------------------------------------------------------------

def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(N, B=2, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=(B, N))
    fg, ign = u < 0.03, u > 0.9
    bg = ~fg & ~ign
    labels = np.where(fg, rng.integers(1, 4, size=(B, N)), 0)
    labels = np.where(ign, 3000, labels).astype(np.int32)
    return {"images": rng.normal(size=(B,) + CROP + (3,)).astype(np.float32),
            "labels": labels, "labels_fg": fg.astype(np.int8),
            "labels_bg": bg.astype(np.int8),
            "labels_ign": ign.astype(np.int8),
            "bbox_2d": (rng.normal(size=(B, 4, N)) * 0.5).astype(np.float32),
            "bbox_3d": (rng.normal(size=(B, 7, N)) * 0.5).astype(np.float32),
            "any_val": np.ones(B, np.int32)}


@pytest.fixture(scope="module")
def steps():
    """Two JAX train steps of the tiny flagship (zero DCN offsets, no
    warmup) from its init, with the states after each."""
    jconf = __graft_entry__._flagship_conf(
        CROP, num_scales=2, backbone="dla34", dtype="float32") \
        .replace(warmup=0.0, box_samples=1.0)
    conf = flagship_conf(CROP, num_scales=2, backbone="dla34",
                         dtype="float32").replace(warmup=0.0, box_samples=1.0)
    rois = j_locate_anchors(jconf.anchors, jconf.feat_size,
                            jconf.feat_stride)
    batch = _batch(rois.shape[0])
    jstate = j_create_train_state(jconf, j_build(jconf),
                                  jax.random.PRNGKey(0), max_iter=100)
    jstep = j_make_train_step(jconf, rois)
    states, stats = [jstate], []
    for _ in range(2):
        jstate, s = jstep(jstate, {k: jnp.asarray(v)
                                   for k, v in batch.items()},
                          jax.random.PRNGKey(1))
        states.append(jstate)
        stats.append({k: float(v) for k, v in s.items()})
    return conf, rois, batch, states, stats


def test_build_starts_dcn_offsets_at_zero(steps):
    """As the JAX package's init: the offset/mask conv of every DCN layer
    starts at zero in both phases, so every neck offset of a fresh model
    sits on the triangle kinks."""
    conf, _, _, jstates, _ = steps
    ref = from_flax_variables({"params": _np(jstates[0].params),
                               "batch_stats": _np(jstates[0].batch_stats)})
    names = [n for n in ref if "conv_offset_mask" in n]
    assert len(names) == 16 and not any(ref[n].any() for n in names)
    for phase in ("eval", "train"):
        sd = build(conf, device="cpu", seed=3, phase=phase).state_dict()
        assert not any(sd[n].any() for n in names), phase


def _port_state(conf, jstate):
    model = build(conf, device="cpu", phase="train")
    model.load_state_dict(from_flax_variables(
        {"params": _np(jstate.params),
         "batch_stats": _np(jstate.batch_stats)}), strict=True)
    return create_train_state(conf, model, max_iter=100)


def _ref_state(jstate):
    return from_flax_variables({"params": _np(jstate.params),
                                "batch_stats": _np(jstate.batch_stats)})


def _check_stats(sd, ref, tol):
    """Every BN running statistic within `tol` of JAX's, relative to its
    largest magnitude."""
    for n in ref:
        if n.endswith(("running_mean", "running_var")):
            err = float((sd[n] - ref[n]).abs().max()
                        / ref[n].abs().max().clamp(min=1e-12))
            assert err < tol, (n, err)


def _check_state(state, jstate, before):
    """The step's updates against JAX's: the median over tensors of each
    tensor's difference against its own largest JAX update (tensors whose
    JAX update is under 1e-6 of the largest have a zero gradient: conv
    biases before a BatchNorm), and the largest difference against the
    largest update; then the BN statistics."""
    sd = state.model.state_dict()
    ref = _ref_state(jstate)
    names = [n for n, _ in state.model.named_parameters()]
    upd = {n: ref[n] - before[n] for n in names}
    top = max(float(u.abs().max()) for u in upd.values())
    diff = {n: float((sd[n] - ref[n]).abs().max()) for n in names}
    own = [diff[n] / float(u.abs().max()) for n, u in upd.items()
           if float(u.abs().max()) >= 1e-6 * top]
    assert max(diff.values()) <= UPDATE_TOL * top, (max(diff.values()), top)
    assert np.median(own) <= UPDATE_MEDIAN_TOL, np.median(own)
    _check_stats(sd, ref, STEP_TOL)


def test_one_and_two_train_steps_match_jax(steps):
    """From shared weights: loss and stats of both steps, the parameters
    and BN statistics after step 1, and the BN statistics after step 2,
    against JAX `make_train_step`.

    Step 2 runs from each framework's own step-1 weights, which differ by
    float32 rounding; that moves selections and kinks of the second step,
    so its updates are not compared here (the mid-training test takes step
    2 from one shared state). Its loss, stats and BN statistics must stay
    within CARRY_TOL of JAX's.
    """
    conf, rois, batch, jstates, jstats = steps
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    state = _port_state(conf, jstates[0])
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    step = make_train_step(conf, rois)
    for i, tol in enumerate((STEP_TOL, CARRY_TOL)):
        stats = step(state, tb)
        assert state.step == i + 1
        assert sorted(stats) == sorted(jstats[i])
        for k, v in jstats[i].items():
            np.testing.assert_allclose(float(stats[k]), v, rtol=tol,
                                       atol=1e-6, err_msg=f"{k} step {i}")
        if i == 0:
            _check_state(state, jstates[1], before)
    _check_stats(state.model.state_dict(), _ref_state(jstates[2]),
                 CARRY_TOL)


def test_train_step_from_a_mid_training_state(steps):
    """Start the port from JAX's state after one step (parameters, BN
    statistics and the SGD momentum trace through `sgd_state_from_optax`)
    and take the second step in both."""
    conf, rois, batch, jstates, jstats = steps
    state = _port_state(conf, jstates[1])
    trace = jstates[1].opt_state[1][0].trace
    state.optimizer.load_state_dict(sgd_state_from_optax(_np(trace), 1))
    mom = dict(_param_entries(_np(trace)))
    assert set(mom) == set(state.optimizer.names)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    stats = make_train_step(conf, rois)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k, v in jstats[1].items():
        np.testing.assert_allclose(float(stats[k]), v, rtol=STEP_TOL,
                                   atol=1e-6, err_msg=k)
    _check_state(state, jstates[2], before)


# ---------------------------------------------------------------------------
# checkpoints and the trainer
# ---------------------------------------------------------------------------

def _tiny_conf(**kw):
    return kitti_3d_anab_fullalign().replace(
        crop_size=[64, 224], test_scale=[64, 224], num_anchor_scales=2,
        back_bone="dla34", compute_dtype="float32", pre_train=False,
        batch_size=2, num_workers=2, eval_batch_size=2, display_iter=2,
        **kw)


def test_checkpoint_round_trip(tmp_path):
    """Sync and async saves restore model, optimizer state and step
    bit-identically into a fresh state."""
    conf = flagship_conf(CROP, num_scales=2, backbone="dla34",
                         dtype="float32").replace(warmup=0.0)
    state = create_train_state(conf, build(conf, device="cpu",
                                           phase="train"), 100)
    rois = j_locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    make_train_step(conf, rois)(state, {k: torch.from_numpy(v) for k, v in
                                        _batch(rois.shape[0]).items()})
    save_checkpoint(str(tmp_path / "w"), state, 1)
    state.step = 2
    save_checkpoint(str(tmp_path / "w"), state, 2, async_save=True)
    wait_for_saves()
    assert latest_step(str(tmp_path / "w")) == 2
    for step in (1, 2):
        fresh = create_train_state(conf, build(conf, device="cpu", seed=5,
                                               phase="train"), 100)
        restore_checkpoint(str(tmp_path / "w"), fresh, step=step)
        assert fresh.step == step
        a, b = state.model.state_dict(), fresh.model.state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a)
        oa, ob = state.optimizer.state_dict(), fresh.optimizer.state_dict()
        assert oa["count"] == ob["count"] == 1
        assert all(torch.equal(oa["state"][n]["momentum_buffer"],
                               ob["state"][n]["momentum_buffer"])
                   for n in oa["state"])


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    from m3dssd_tpu.data.synthetic import generate

    root = str(tmp_path_factory.mktemp("kitti_trainer"))
    generate(root, num_train=4, num_val=2, seed=3, imW=224, imH=64,
             min_h_px=6)
    return root


def test_trainer_resume_epoch_cadence(kitti_root, tmp_path):
    """As the JAX trainer: after a restore, the epoch numbering and the
    eval / snapshot cadence continue from the restored step."""
    def make(out):
        tr = Trainer(_tiny_conf(snapshot_epoch=1, eval_epoch=2, max_epoch=4),
                     kitti_root, str(out), device="cpu")
        evals = []
        tr._eval = lambda epoch: (evals.append(epoch), 0.0)[1]
        return tr, evals

    tr, evals = make(tmp_path / "run")
    spe = tr.steps_per_epoch
    tr.run(2)
    assert tr.state.step == 2 * spe and evals == [2]
    weights = str(tmp_path / "run" / "weights")
    assert latest_step(weights) == 2 * spe

    tr2, evals2 = make(tmp_path / "run2")
    restore_checkpoint(weights, tr2.state)
    assert tr2.state.step == 2 * spe
    tr2.run(2)
    assert tr2.state.step == 2 * spe and evals2 == []
    tr2.run(4)
    assert tr2.state.step == 4 * spe and evals2 == [4]


def test_trainer_epoch_with_eval_and_best_model(kitti_root, tmp_path):
    """One epoch on the split on disk with the periodic eval through the
    port's test_kitti_3d on an in-memory validation split: result txts,
    the AP keys, a snapshot, a best model, and the run-dir rename."""
    conf = _tiny_conf(snapshot_epoch=1, eval_epoch=1, max_epoch=1)
    val = SyntheticEvalSet(conf, 4, seed=4, imW=224, imH=64, min_h_px=6)
    tr = Trainer(conf, kitti_root, str(tmp_path / "run"), device="cpu",
                 val_dataset=val)
    tr.run(1)
    assert tr.state.step == tr.steps_per_epoch == 2
    res = tr.last_eval
    assert "Car_3d_R40" in res and len(res["Car_3d_R40"]) == 3
    out = tr.output_dir
    txts = os.listdir(os.path.join(out, "results", "results_1", "data"))
    assert sorted(txts) == [f"{i:06d}.txt" for i in range(4)]
    assert latest_step(os.path.join(out, "weights")) == 2
    assert latest_step(os.path.join(out, "weights_best")) == 2
    assert all(np.isfinite(float(v)) for v in tr.last_stats.values())
    assert tr.model.training
    tr.best_metric = 12.5
    assert tr.finalize_run_dir() == out + "_12.5000"
    assert os.path.isdir(out + "_12.5000")

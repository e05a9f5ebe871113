"""The port's data parallelism (`m3dssd_tpu_torch/parallel/`) on the CPU:
two ranks of a gloo group in fresh processes (tests/torch_parallel_runner.py,
a file store) against one process on the global batch, and against the
JAX package's single-device step.

A data-parallel step must be the single-process step on the global batch,
as a JAX 'data' mesh is (tests/test_loss_train.py): BatchNorm's statistics
over the global batch, the loss's counts and denominators global, the
gradients summed over the ranks. Both ranks must end with bit-equal
parameters.

Tolerances. BatchNorm in float64: 1e-10. The loss: float32 sums in
another order, 1e-5 of the value (the gradient 1e-6 of its largest). A
whole float32 step against JAX: the limits of tests/test_torch_train.py.
The same step against the port's single-process step: each rank's conv
gradient sums its own rows, so the summed gradient differs from the
single-process one in float32 rounding, and a whole step is not smooth at
that scale (PERF.md). It is held by the median over tensors of each
tensor's update error at 1e-5 (read: 7.6e-8), the largest error at 1e-4
of the largest update (read: 5.9e-6; the Trainer's step 1.0e-5) and the
stats and BN statistics at 1e-5. In float64 the step is held at 1e-9 (read:
3e-14; the loss computes in float32, so its stats at 1e-6), in a case where
one rank's align overflows into the dense form while the other stays
sparse. One test, marked `cuda`, holds the group BatchNorm's card path
(torch's fused batch-norm kernels) against cuDNN's BatchNorm.
"""

import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import __graft_entry__
from m3dssd_tpu.anchors import locate_anchors as j_locate_anchors
from m3dssd_tpu.data.loader import TrainLoader as JTrainLoader
from m3dssd_tpu.losses.rpn_loss import RPNLossConfig as JCfg
from m3dssd_tpu.losses.rpn_loss import rpn_3d_loss as j_rpn_3d_loss
from m3dssd_tpu.models import build as j_build
from m3dssd_tpu.train.state import create_train_state as j_create_train_state
from m3dssd_tpu.train.state import make_train_step as j_make_train_step
from m3dssd_tpu_torch.config import flagship_conf
from m3dssd_tpu_torch.data.loader import TrainLoader
from m3dssd_tpu_torch.data.synthetic import (SyntheticEvalSet,
                                             SyntheticTrainSet)
from m3dssd_tpu_torch.losses.rpn_loss import RPNLossConfig, rpn_3d_loss
from m3dssd_tpu_torch.models import bias_background, build, rpn
from m3dssd_tpu_torch.models.layers import batch_norm
from m3dssd_tpu_torch.parallel import make_mesh, shard_batch
from m3dssd_tpu_torch.train.state import create_train_state, make_train_step
from m3dssd_tpu_torch.train.trainer import Trainer, data_parallel_size
from m3dssd_tpu_torch.utils.weights import from_flax_variables

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_train import STEP_TOL, _batch, _check_state, _np  # noqa
from test_torch_train_data import _compare_batches, data  # noqa: F401,E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_parallel_runner.py")
WORLD = 2
STEP_CROP = (64, 128)
EVAL_CROP = (64, 224)
IM = dict(imW=224, imH=64, min_h_px=6)
BN_TOL = 1e-10
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
# the two-rank float32 step against the single-process one (see above)
DP_STEP_TOL = {"stats": 1e-5, "update_median": 1e-5, "update_largest": 1e-4}
F64_TOL = 1e-9
# the loss computes in float32 on a float64 model: its stats to 1e-6
LOSS_TOL_F64 = 1e-6
# the float64 case's background bias: some positions confident, their
# count varying by image (`_split_align_forms`)
FORMS_BIAS = 2.0


def _step_conf(**kw):
    return dict(crop=STEP_CROP, warmup=0.0, box_samples=1.0, **kw)


def _eval_conf():
    return dict(crop=EVAL_CROP, hill_climbing=False, score_thres=0.2)


def _trainer_conf():
    return dict(crop=EVAL_CROP, anchors=None, batch_size=4, num_workers=2,
                eval_batch_size=2, display_iter=1, snapshot_epoch=1,
                eval_epoch=1, max_epoch=1, warmup=0.0)


def _port_conf(kw):
    kw = dict(kw)
    return flagship_conf(kw.pop("crop"), num_scales=2, backbone="dla34",
                         dtype="float32").replace(**kw)


def _start(case, work):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, RUNNER, case, str(r),
                              str(WORLD), str(work)], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True) for r in range(WORLD)]


def _finish(case, work, procs, timeout=600):
    for p in procs:
        out, _ = p.communicate(timeout=timeout)
        assert p.returncode == 0, out[-4000:]
    return [torch.load(os.path.join(work, f"{case}.rank{r}.pt"),
                       weights_only=False) for r in range(WORLD)]


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _loss_inputs(N, B=4):
    """Model outputs and a batch of B rows for the loss, from a numpy
    seed (tests/test_torch_loss.py's draws)."""
    rng = np.random.default_rng(1)
    cls_t = (rng.normal(size=(B, 4, N)) * 2).astype(np.float32)
    e = np.exp(cls_t - cls_t.max(1, keepdims=True))
    outputs = {"cls_t": cls_t,
               "prob_t": (e / e.sum(1, keepdims=True)).astype(np.float32),
               "lse": np.log(np.exp(cls_t.astype(np.float64)).sum(1))
               .astype(np.float32),
               "bbox_2d": (rng.normal(size=(B, 4, N)) * 0.5)
               .astype(np.float32),
               "bbox_3d": (rng.normal(size=(B, 7, N)) * 0.8)
               .astype(np.float32)}
    u = rng.uniform(size=(B, N))
    fg, ign = u < 0.03, u > 0.9
    labels = np.where(fg, rng.integers(1, 4, size=(B, N)), 0)
    batch = {"labels": np.where(ign, 3000, labels).astype(np.int32),
             "labels_fg": fg.astype(np.int8),
             "labels_bg": (~fg & ~ign).astype(np.int8),
             "labels_ign": ign.astype(np.int8),
             "bbox_2d": (rng.normal(size=(B, 4, N)) * 0.5)
             .astype(np.float32),
             "bbox_3d": (rng.normal(size=(B, 7, N)) * 0.5)
             .astype(np.float32),
             "any_val": np.ones(B, np.int32)}
    return outputs, batch


def _loss_cases(conf, rois):
    """Outputs and a batch of 4 rows for each loss case: every row with
    fg; the second rank's rows without fg (ignored anchors keep them in
    the sampling); random sampling (hard_negatives off) from a shared
    generator."""
    outputs, batch = _loss_inputs(rois.shape[0])
    nofg = dict(batch)
    nofg["labels"] = batch["labels"].copy()
    nofg["labels"][2:][batch["labels_fg"][2:] > 0] = 0
    nofg["labels_fg"] = batch["labels_fg"].copy()
    nofg["labels_fg"][2:] = 0
    nofg["labels_bg"] = (nofg["labels"] == 0).astype(np.int8)
    consts = (rois[:, :5].astype(np.float32),
              np.asarray(conf.anchors, np.float32),
              np.asarray(conf.bbox_means, np.float32),
              np.asarray(conf.bbox_stds, np.float32))
    cfg = RPNLossConfig.from_conf(conf).__dict__
    p2 = np.array([[721.5377, 0.0, 609.5593, 44.85728],
                   [0.0, 721.5377, 172.854, 0.2163791],
                   [0.0, 0.0, 1.0, 0.002745884], [0.0, 0.0, 0.0, 1.0]])
    proj = dict(batch, p2_inv=np.stack([np.linalg.inv(p2)] * 4)
                .astype(np.float32))
    cases = {"base": (batch, {}), "no_fg_rank": (nofg, {}),
             "random": (batch, {"hard_negatives": False}),
             "proj_giou": (proj, {"bbox_3d_proj_lambda": 1.0,
                                  "bbox_3d_iou_lambda": 1.0})}
    return {name: {"outputs": _t(outputs), "batch": _t(b),
                   "consts": tuple(torch.from_numpy(c) for c in consts),
                   "cfg": {**cfg, **over}}
            for name, (b, over) in cases.items()}


def _bn_inputs():
    rng = np.random.default_rng(0)
    return {"x": torch.tensor(rng.normal(size=(4, 16, 6, 10)) * 3.0 + 1.0),
            "ct": torch.tensor(rng.normal(size=(4, 16, 6, 10))),
            "weight": torch.tensor(rng.uniform(0.5, 1.5, size=16)),
            "bias": torch.tensor(rng.normal(size=16)),
            "running_mean": torch.full((16,), 0.3, dtype=torch.float64),
            "running_var": torch.full((16,), 2.0, dtype=torch.float64)}


def _single_step(conf, sd, batch, dtype):
    model = build(conf, device="cpu", phase="train")
    model.load_state_dict(sd, strict=True)
    model.to(dtype)
    state = create_train_state(conf, model, max_iter=100)
    rois = j_locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    stats = make_train_step(conf, rois)(state, {
        k: v.to(dtype) if v.is_floating_point() else v
        for k, v in batch.items()})
    return {"stats": {k: float(v) for k, v in stats.items()},
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def _split_align_forms(model, batch):
    """(batch, align budget per image) such that the first rank's two
    images hold more confident positions than the budget allows for two
    images (dense align) and the second rank's fewer (sparse): the
    batch's rows reordered by their confident positions, counted on
    `model`'s train-mode forward of the whole batch."""
    counts = []
    real = rpn.confident_topm

    def spy(prob, thresh, m):
        mask = torch.max(prob.detach(), dim=-1).values > thresh
        counts.append(mask.reshape(mask.shape[0], -1).sum(1).tolist())
        return real(prob, thresh, m)

    rpn.confident_topm = spy
    try:
        with torch.no_grad():
            model(batch["images"].double())
    finally:
        rpn.confident_topm = real
    c = counts[0]
    order = sorted(range(4), key=lambda i: -c[i])
    hi, lo = c[order[0]] + c[order[1]], c[order[2]] + c[order[3]]
    assert hi >= lo + 2, c
    batch = {k: v[order] for k, v in batch.items()}
    return batch, (lo + 1) // 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both two-rank launches (the core cases and a Trainer epoch) and, while
    they run, the references: JAX's step on the global batch, the port's
    single-process step, loss, BatchNorm, eval and Trainer."""
    work = tmp_path_factory.mktemp("dp_core")
    twork = tmp_path_factory.mktemp("dp_trainer")
    jconf = __graft_entry__._flagship_conf(
        STEP_CROP, num_scales=2, backbone="dla34", dtype="float32") \
        .replace(warmup=0.0, box_samples=1.0)
    conf = _port_conf(_step_conf())
    rois = j_locate_anchors(jconf.anchors, jconf.feat_size,
                            jconf.feat_stride)
    jstate = j_create_train_state(jconf, j_build(jconf),
                                  jax.random.PRNGKey(0), max_iter=100)
    init = from_flax_variables({"params": _np(jstate.params),
                                "batch_stats": _np(jstate.batch_stats)})
    batch = _t(_batch(rois.shape[0], B=4))
    fmodel = bias_background(build(conf, device="cpu", seed=0,
                                   phase="train"), conf.num_classes,
                             FORMS_BIAS).double()
    fsd = {k: v.clone() for k, v in fmodel.state_dict().items()}
    fbatch, topm = _split_align_forms(fmodel, _t(_batch(rois.shape[0], B=4,
                                                        seed=1)))
    fconf = _port_conf(_step_conf(sparse_align_topm=topm))
    inputs = {
        "bn": _bn_inputs(), "loss": _loss_cases(conf, rois),
        "step": {"conf": _step_conf(), "state": init, "batch": batch},
        "forms": {"conf": _step_conf(sparse_align_topm=topm),
                  "state": fsd, "batch": fbatch},
        "eval": {"conf": _eval_conf(), "n": 9, "bs": 2, "im": IM,
                 "dir": str(work)},
        "trainer": {"conf": _trainer_conf(), "n": 4, "im": IM,
                    "dir": str(twork / "run")}}
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    torch.save(inputs, os.path.join(twork, "inputs.pt"))
    procs = {"core": (work, _start("core", work)),
             "trainer": (twork, _start("trainer", twork))}
    try:
        ref = {"init": init, "jstate": jstate, "conf": conf, "rois": rois}
        jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
        jnext, js = j_make_train_step(jconf, rois)(jstate, jb,
                                                   jax.random.PRNGKey(1))
        ref["jnext"] = jnext
        ref["jstats"] = {k: float(v) for k, v in js.items()}
        ref["f32"] = _single_step(conf, init, batch, torch.float32)
        ref["f64"] = _single_step(fconf, fsd, fbatch, torch.float64)
        ref["trainer"] = _single_trainer(tmp_path_factory)
        ref["eval"] = _single_eval(work)
        out = {name: _finish(name, w, p) for name, (w, p) in procs.items()}
    finally:
        for _, ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    return inputs, ref, out


def _single_trainer(tmp_path_factory):
    conf = _port_conf(_trainer_conf())
    ds = SyntheticTrainSet(conf, 4, seed=3, **IM)
    val = SyntheticEvalSet(conf, 4, seed=4, **IM)
    tr = Trainer(conf, None, str(tmp_path_factory.mktemp("single") / "run"),
                 device="cpu", dataset=ds, val_dataset=val)
    tr.run(1)
    return {"loss": float(tr.last_stats["loss"]),
            "state": tr.model.state_dict(), "best": tr.best_metric}


def _single_eval(work):
    from m3dssd_tpu_torch.inference.detect import make_batch_detector
    from m3dssd_tpu_torch.inference.test_driver import test_kitti_3d

    conf = _port_conf(_eval_conf())
    val = SyntheticEvalSet(conf, 9, seed=4, **IM)
    gt = val.write_labels(os.path.join(work, "gt_single"))
    model = build(conf, device="cpu", seed=3)
    rois = j_locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    det = make_batch_detector(conf, rois, model, device="cpu")
    d = os.path.join(work, "one_process")
    _, sel = test_kitti_3d(val, det, conf, d, gt_path=gt, batch_size=2)
    return {"sel": sel, "txts": {f: open(os.path.join(d, f)).read()
                                 for f in sorted(os.listdir(d))}}


# ---------------------------------------------------------------------------
# BatchNorm over the global batch
# ---------------------------------------------------------------------------

def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))


def test_group_batchnorm_matches_one_process(runs):
    """Output, input gradient and running statistics of two ranks equal
    the port's BatchNorm on the whole input (float64, 1e-10); the scale
    and bias gradients sum over the ranks to its. Without the group each
    rank's output is far from it (the statistics are its own half's)."""
    inputs, _, out = runs
    bn = inputs["bn"]
    m = batch_norm(16).double().train()
    with torch.no_grad():
        for k in ("weight", "bias", "running_mean", "running_var"):
            getattr(m, k).copy_(bn[k])
    x = bn["x"].clone().requires_grad_()
    y = m(x)
    (y * bn["ct"]).sum().backward()
    got = [o["bn"]["group"] for o in out["core"]]
    assert _rel(torch.cat([g["y"] for g in got]), y.detach()) < BN_TOL
    assert _rel(torch.cat([g["dx"] for g in got]), x.grad) < BN_TOL
    assert _rel(got[0]["dw"] + got[1]["dw"], m.weight.grad) < BN_TOL
    assert _rel(got[0]["db"] + got[1]["db"], m.bias.grad) < BN_TOL
    for g in got:
        assert _rel(g["rm"], m.running_mean) < BN_TOL
        assert _rel(g["rv"], m.running_var) < BN_TOL
    local = torch.cat([o["bn"]["local"]["y"] for o in out["core"]])
    assert _rel(local, y.detach()) > 1e-3


def test_group_batchnorm_matches_flax(runs):
    """The two ranks against flax's BatchNorm on the whole input, with the
    limits of tests/test_torch_train.py's train-mode test."""
    inputs, _, out = runs
    bn = inputs["bn"]
    to_nhwc = (0, 2, 3, 1)
    x = bn["x"].numpy().transpose(to_nhwc).astype(np.float32)
    ct = bn["ct"].numpy().transpose(to_nhwc).astype(np.float32)
    stats = {"mean": bn["running_mean"].numpy().astype(np.float32),
             "var": bn["running_var"].numpy().astype(np.float32)}
    flax_bn = nn.BatchNorm(use_running_average=False, momentum=0.9)

    def f(x, p):
        y, mut = flax_bn.apply({"params": p, "batch_stats": stats}, x,
                               mutable=["batch_stats"])
        return jnp.sum(y * ct), (y, mut)

    (gx, gp), (y, mut) = jax.grad(f, argnums=(0, 1), has_aux=True)(
        x, {"scale": bn["weight"].numpy().astype(np.float32),
            "bias": bn["bias"].numpy().astype(np.float32)})
    got = [o["bn"]["group"] for o in out["core"]]
    lim = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        torch.cat([g["y"] for g in got]).numpy().transpose(to_nhwc), y,
        **lim)
    np.testing.assert_allclose(
        torch.cat([g["dx"] for g in got]).numpy().transpose(to_nhwc), gx,
        **lim)
    np.testing.assert_allclose((got[0]["dw"] + got[1]["dw"]).numpy(),
                               gp["scale"], **lim)
    np.testing.assert_allclose((got[0]["db"] + got[1]["db"]).numpy(),
                               gp["bias"], **lim)
    for g in got:
        np.testing.assert_allclose(g["rm"].numpy(),
                                   mut["batch_stats"]["mean"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(g["rv"].numpy(),
                                   mut["batch_stats"]["var"], rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2.0 ** -7)])
def test_group_batchnorm_fused_kernels_on_card(tmp_path, dtype, tol):
    """On a card the group BatchNorm runs torch's fused batch-norm kernels:
    under a one-rank group it equals the one-process BatchNorm2d (cuDNN)
    on channels-last input, forward and backward, to rounding (output and
    dx within two ulps of their largest in bf16; the scale and bias
    gradients and the running statistics within 1e-5), also with a
    channel of zero variance."""
    import torch.distributed as dist

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        g = torch.Generator(device="cuda").manual_seed(0)
        scale = torch.arange(1, 5, device="cuda").view(4, 1, 1, 1)
        x = torch.randn(4, 24, 20, 36, generator=g, device="cuda") * scale
        x[:, 3] = 2.0
        x = x.to(dtype).contiguous(memory_format=torch.channels_last)
        dy = torch.randn(x.shape, generator=g, device="cuda").to(dtype)
        w = torch.rand(24, generator=g, device="cuda") + 0.5
        b = torch.randn(24, generator=g, device="cuda")
        out = {}
        for key, group in (("group", dist.group.WORLD), ("plain", None)):
            m = batch_norm(24).cuda().train()
            m.process_group = group
            with torch.no_grad():
                m.weight.copy_(w)
                m.bias.copy_(b)
            xi = x.detach().requires_grad_()
            y = m(xi)
            y.backward(dy)
            out[key] = {"y": y, "dx": xi.grad, "dw": m.weight.grad,
                        "db": m.bias.grad, "rm": m.running_mean,
                        "rv": m.running_var}
        for k, want in out["plain"].items():
            lim = tol if k in ("y", "dx") else 1e-5
            assert _rel(out["group"][k].float(), want.float()) <= lim, k
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["base", "no_fg_rank", "random",
                                  "proj_giou"])
def test_loss_over_two_ranks_matches_one_process(runs, name):
    """The ranks' losses sum to the loss on the whole batch, their output
    gradients are its gradient's rows, and both report its stats: with fg
    on every row, with no fg on the second rank (its local denominators
    are 0), with random sampling drawn from one generator state, and with
    the 3D-projection and 3D-GIoU branches on (their means over the global
    fg count)."""
    inputs, _, out = runs
    case = inputs["loss"][name]
    outputs = {k: v.clone().requires_grad_()
               for k, v in case["outputs"].items()}
    loss, stats = rpn_3d_loss(outputs, case["batch"], *case["consts"],
                              RPNLossConfig(**case["cfg"]),
                              torch.Generator().manual_seed(5))
    names = ("cls_t", "lse", "bbox_2d", "bbox_3d")
    grads = torch.autograd.grad(loss, [outputs[k] for k in names])
    got = [o["loss"][name] for o in out["core"]]
    assert float(stats["fg_count"]) > 0
    if name == "no_fg_rank":
        assert not case["batch"]["labels_fg"][2:].any()
    if name == "proj_giou":
        assert "loss_bbox3d_proj" in stats and "loss_bbox3d_iou" in stats
    np.testing.assert_allclose(float(got[0]["loss"] + got[1]["loss"]),
                               float(loss), **LOSS_TOL)
    for k, want in zip(names, grads):
        g = torch.cat([r["grads"][k] for r in got])
        assert _rel(g, want) < 1e-6, k
    for r in got:
        assert sorted(r["stats"]) == sorted(stats)
        for k, v in stats.items():
            np.testing.assert_allclose(float(r["stats"][k]), float(v),
                                       err_msg=k, **LOSS_TOL)


def test_loss_over_two_ranks_matches_jax(runs):
    """The ranks' summed loss and their stats against the JAX package's
    loss on the whole batch (tests/test_torch_loss.py's limits)."""
    inputs, _, out = runs
    case = inputs["loss"]["base"]
    jcfg = JCfg(**{k: v for k, v in case["cfg"].items()})
    jl, js = j_rpn_3d_loss(
        {k: jnp.asarray(v.numpy()) for k, v in case["outputs"].items()},
        {k: jnp.asarray(v.numpy()) for k, v in case["batch"].items()},
        *[jnp.asarray(c.numpy()) for c in case["consts"]], jcfg)
    got = [o["loss"]["base"] for o in out["core"]]
    tol = dict(rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(float(got[0]["loss"] + got[1]["loss"]),
                               float(jl), **tol)
    for k, v in js.items():
        np.testing.assert_allclose(float(got[1]["stats"][k]), float(v),
                                   err_msg=k, **tol)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _as_state(conf, sd):
    model = build(conf, device="cpu", phase="train")
    model.load_state_dict(sd, strict=True)
    return types.SimpleNamespace(model=model)


def _update_errors(after, ref, before, names):
    upd = {n: ref[n].double() - before[n].double() for n in names}
    top = max(float(u.abs().max()) for u in upd.values())
    own = [float((after[n].double() - ref[n].double()).abs().max())
           / float(u.abs().max()) for n, u in upd.items()
           if float(u.abs().max()) >= 1e-6 * top]
    largest = max(float((after[n].double() - ref[n].double()).abs().max())
                  for n in names) / top
    return float(np.median(own)), largest


def test_step_over_two_ranks_matches_jax(runs):
    """One step of 2 ranks x 2 rows from the JAX package's init against
    JAX's step on the global batch of 4 on one device: the stats, the
    updates and the BN statistics (tests/test_torch_train.py's rules). The
    ranks reduced every trainable gradient and end bit-equal."""
    _, ref, out = runs
    got = [o["step"]["f32"] for o in out["core"]]
    for k, v in ref["jstats"].items():
        np.testing.assert_allclose(got[0]["stats"][k], v, rtol=STEP_TOL,
                                   atol=1e-6, err_msg=k)
    assert got[0]["stats"] == got[1]["stats"]
    a, b = got[0]["state"], got[1]["state"]
    assert all(torch.equal(a[k], b[k]) for k in a)
    _check_state(_as_state(ref["conf"], a), ref["jnext"], ref["init"])
    model = build(ref["conf"], device="cpu", phase="train")
    nbytes = sum(p.numel() * 4 for p in model.parameters())
    assert got[0]["reduced_bytes"] == got[1]["reduced_bytes"] == nbytes


def test_step_over_two_ranks_matches_one_process(runs):
    """The same step against the port's single-process step on the 4 rows
    (DP_STEP_TOL)."""
    _, ref, out = runs
    got = out["core"][0]["step"]["f32"]
    want = ref["f32"]
    for k, v in want["stats"].items():
        np.testing.assert_allclose(got["stats"][k], v,
                                   rtol=DP_STEP_TOL["stats"], atol=1e-7,
                                   err_msg=k)
    names = [n for n, _ in build(ref["conf"], device="cpu",
                                 phase="train").named_parameters()]
    median, largest = _update_errors(got["state"], want["state"],
                                     ref["init"], names)
    assert median <= DP_STEP_TOL["update_median"], median
    assert largest <= DP_STEP_TOL["update_largest"], largest
    for n, v in want["state"].items():
        if n.endswith(("running_mean", "running_var")):
            assert _rel(got["state"][n], v) < DP_STEP_TOL["stats"], n


def test_float64_step_with_different_align_forms(runs):
    """In float64, with the align budget set so the first rank's images
    overflow into the dense align and the second's stay sparse, the two
    ranks' step equals the single-process step to 1e-9, and both ranks
    end bit-equal."""
    inputs, ref, out = runs
    got = [o["step"]["forms"] for o in out["core"]]
    assert got[0]["forms"] == ["dense"] and got[1]["forms"] == ["sparse"]
    want = ref["f64"]
    a, b = got[0]["state"], got[1]["state"]
    assert all(torch.equal(a[k], b[k]) for k in a)
    for k, v in want["stats"].items():
        np.testing.assert_allclose(got[0]["stats"][k], v, rtol=LOSS_TOL_F64,
                                   atol=1e-12, err_msg=k)
    names = [n for n, _ in build(ref["conf"], device="cpu",
                                 phase="train").named_parameters()]
    median, largest = _update_errors(a, want["state"],
                                     inputs["forms"]["state"], names)
    assert median <= F64_TOL and largest <= F64_TOL, (median, largest)
    for n, v in want["state"].items():
        if n.endswith(("running_mean", "running_var")):
            assert _rel(a[n], v) <= F64_TOL, n


# ---------------------------------------------------------------------------
# the loader, the Trainer, the eval driver and the CLIs
# ---------------------------------------------------------------------------

def test_sliced_loader_matches_single_process_and_jax(data):
    """Each process's batch is bit-equal to its rows of the
    single-process batch, and matches the JAX loader with the same
    slicing (the images within the warp's tolerance: the JAX loader
    warps with OpenCV)."""
    _, jds, tds = data
    whole = list(TrainLoader(tds, 4, num_workers=2, seed=5,
                             pin=False).batches(2))
    for r in range(WORLD):
        mine = list(TrainLoader(tds, 4, num_workers=2, seed=5, pin=False,
                                process_index=r,
                                process_count=WORLD).batches(2))
        theirs = list(JTrainLoader(jds, 4, num_workers=2, seed=5,
                                   process_index=r,
                                   process_count=WORLD).batches(2))
        mesh = types.SimpleNamespace(rank=r, size=WORLD)
        for g, w, j in zip(mine, whole, theirs):
            want = shard_batch(mesh, w)
            assert sorted(g) == sorted(want)
            assert all(torch.equal(g[k], want[k]) for k in g)
            _compare_batches(g, j)


def test_trainer_over_two_ranks(runs):
    """One epoch of the Trainer on 2 ranks: the same loss on both, equal to
    a single-process Trainer's, the parameters after the step likewise
    (DP_STEP_TOL), the same eval metric; the run directory written once by
    rank 0, rank 1's log beside rank 0's."""
    inputs, ref, out = runs
    got = out["trainer"]
    want = ref["trainer"]
    assert got[0]["loss"] == got[1]["loss"]
    np.testing.assert_allclose(got[0]["loss"], want["loss"],
                               rtol=DP_STEP_TOL["stats"])
    assert got[0]["step"] == got[1]["step"] == 1
    assert got[0]["best"] == got[1]["best"] == want["best"]
    assert not got[0]["eval_none"] and got[1]["eval_none"]
    a, b = got[0]["state"], got[1]["state"]
    assert all(torch.equal(a[k], b[k]) for k in a)
    conf = _port_conf(_trainer_conf())
    SyntheticTrainSet(conf, 4, seed=3, **IM)
    init = build(conf, device="cpu", seed=conf.rng_seed,
                 phase="train").state_dict()
    names = [n for n, _ in build(conf, device="cpu",
                                 phase="train").named_parameters()]
    median, largest = _update_errors(a, want["state"], init, names)
    assert median <= DP_STEP_TOL["update_median"], median
    assert largest <= DP_STEP_TOL["update_largest"], largest
    run = inputs["trainer"]["dir"]
    assert os.path.exists(os.path.join(run, "conf.pkl"))
    assert os.path.isdir(os.path.join(run, "model_src"))
    assert sorted(os.listdir(os.path.join(run, "weights"))) == ["step_1"]
    for d in ("weights", "weights_best"):
        assert os.listdir(os.path.join(run, d, "step_1")) == ["state.pt"]
    # rank 0 alone writes the TensorBoard events (log/tb)
    assert sorted(os.listdir(os.path.join(run, "log"))) == [
        "tb", "train.log", "train.p1.log"]
    assert len(os.listdir(os.path.join(run, "log", "tb"))) == 1
    assert len(os.listdir(os.path.join(run, "results", "results_1",
                                       "data"))) == 4


def test_eval_over_two_ranks_writes_one_process_txts(runs):
    """test_kitti_3d over 2 ranks (9 images at batch 2: rank 0 runs
    batches 0, 2 and the padded tail, rank 1 batches 1 and 3) writes the
    single-process driver's bytes; both ranks return its metric, and the
    results dict only on rank 0."""
    _, ref, out = runs
    got = [o["eval"] for o in out["core"]]
    want = ref["eval"]
    assert len(want["txts"]) == 9
    assert sum(len(t.splitlines()) for t in want["txts"].values()) > 0
    assert got[0]["txts"] == want["txts"]
    assert got[0]["sel"] == got[1]["sel"] == want["sel"]
    assert not got[0]["res_is_none"] and got[1]["res_is_none"]


def test_sub_axis_and_kernel_build_barrier(runs):
    """A data axis of 1 in a world of 2 leaves rank 1 outside; local rank
    0 builds the kernels before the other ranks look for them."""
    _, _, out = runs
    got = [o["mesh"] for o in out["core"]]
    assert got[0]["sub"] == (0, 1, True) and got[1]["sub"] == (1, 1, False)
    assert got[0]["built_first"] == [True]
    assert got[1]["built_first"] == [True]


def test_train_and_test_clis_under_torchrun(tmp_path):
    """The train CLI with --distributed, and the test CLI with
    --mesh_devices 2, under `python -m torch.distributed.run --standalone
    --nproc_per_node 2` on the CPU: one run directory, rank 1's log, and
    the AP table printed once."""
    from m3dssd_tpu_torch.data.synthetic import generate

    root = str(tmp_path / "data")
    generate(root, num_train=4, num_val=2, seed=3, imW=224, imH=64,
             min_h_px=6)
    run = str(tmp_path / "run")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    launch = [sys.executable, "-m", "torch.distributed.run", "--standalone",
              "--nproc_per_node", "2", "-m"]
    res = subprocess.run(
        launch + ["m3dssd_tpu_torch.scripts.train", "--distributed",
                  "--cpu", "--config", "kitti_3d_anab_fullalign",
                  "--data_root", root, "--output", run, "--cache",
                  str(tmp_path / "cache"), "--epochs", "1", "--batch_size",
                  "2", "--backbone", "dla34", "--crop", "64", "224",
                  "--no_pretrain"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.count("run directory:") == 2
    # rank 0 alone writes the TensorBoard events (log/tb)
    assert sorted(os.listdir(os.path.join(run, "log"))) == [
        "tb", "train.log", "train.p1.log"]
    assert len(os.listdir(os.path.join(run, "log", "tb"))) == 1
    assert os.listdir(os.path.join(run, "seed")) == ["seed.pt"]
    res = subprocess.run(
        launch + ["m3dssd_tpu_torch.scripts.test", "--mesh_devices", "2",
                  "--cpu", "--run_dir", run, "--data_root", root],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.count("selection metric") == 1
    data = [os.path.join(run, "results", d, "data") for d in
            os.listdir(os.path.join(run, "results"))
            if d.startswith("results_test_")]
    assert len(data) == 1 and len(os.listdir(data[0])) == 2


# ---------------------------------------------------------------------------
# sizing (the spatial and model axes: tests/test_torch_mesh_axes.py)
# ---------------------------------------------------------------------------

def test_one_process_mesh_needs_no_group():
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.group, mesh.member) == (0, 1, None,
                                                               True)


@pytest.mark.parametrize("batch,dp,world,want", [
    (8, -1, 2, 2), (8, -1, 3, 2), (8, -1, 4, 4), (6, -1, 4, 3),
    (8, 2, 4, 2), (4, -1, 8, 4)])
def test_data_parallel_size_is_jax_largest_divisor(batch, dp, world, want):
    conf = flagship_conf((64, 128)).replace(batch_size=batch,
                                            dp_devices=dp)
    assert data_parallel_size(conf, world) == want


def test_data_parallel_size_warns_and_raises(caplog):
    """Fewer ranks on the data axis than processes: a warning; an axis of 1
    under several processes: an error (they would train apart)."""
    conf = flagship_conf((64, 128))
    with caplog.at_level("WARNING"):
        assert data_parallel_size(conf.replace(batch_size=8), 3) == 2
    assert "idle" in caplog.text
    with pytest.raises(ValueError, match="apart"):
        data_parallel_size(conf.replace(batch_size=3), 2)
    caplog.clear()
    with caplog.at_level("WARNING"):
        assert data_parallel_size(conf.replace(batch_size=3), 1) == 1
    assert caplog.text == ""

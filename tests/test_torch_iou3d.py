"""The port's rotated IoU, 3D GIoU and rotated-BEV NMS (`ops/iou3d.py`)
against the JAX package's, and the loss's 3D-projection and 3D-GIoU
branches that use them.

Box sets: random boxes, identical pairs, duplicates rotated by pi,
disjoint pairs, pairs that touch along an edge, and pairs whose edges are
near-parallel (rotated by 1e-6 and offset, so the crossings stay apart).
In float64 (JAX jitted under `jax.enable_x64`) values and autograd
gradients agree within 1e-9: the two order the polygon's vertices the
same way (a stable sort of the same angles), so they sum the same
triangles. Identical boxes and duplicates rotated by pi are the
exception: there each corner of one box coincides with a corner of the
other up to the last bit of the corner arithmetic, which XLA's fused
program and torch round differently, so which of two coincident corners
comes first in the angle sort (and wins the hull's max) is decided by
rounding. Both boxes are then one physical box, whose corners move alike
with either box's parameters, so there the gradients are held as d/da +
d/db (which does not depend on that choice), within the same 1e-9. In
float32 the IoU and GIoU agree within 1e-5 and every gradient is finite.

The loss branches are held against the JAX loss run op by op, as
`test_torch_loss.py` runs it, with that file's limits.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from m3dssd_tpu.anchors import locate_anchors as j_locate_anchors
from m3dssd_tpu.losses.rpn_loss import RPNLossConfig as JCfg
from m3dssd_tpu.losses.rpn_loss import rpn_3d_loss as j_rpn_3d_loss
from m3dssd_tpu.ops import iou3d as J
from m3dssd_tpu_torch.losses.rpn_loss import RPNLossConfig, rpn_3d_loss
from m3dssd_tpu_torch.ops import iou3d as T

# one torch thread per test process: the suite runs several workers at
# once, and torch's default of one thread per core made them
# oversubscribe the machine and slow every worker down
torch.set_num_threads(1)

F64_TOL = 1e-9           # float64 values and gradients
F32_TOL = 1e-5           # float32 IoU and GIoU
N_BOX = 24


def _random(rng, n):
    b = np.zeros((n, 7))
    b[:, 0] = rng.uniform(-3, 3, n)
    b[:, 1] = rng.uniform(1.0, 2.0, n)
    b[:, 2] = rng.uniform(10, 14, n)
    b[:, 3] = rng.uniform(1.2, 2.0, n)
    b[:, 4] = rng.uniform(1.4, 2.0, n)
    b[:, 5] = rng.uniform(3.0, 5.0, n)
    b[:, 6] = rng.uniform(-math.pi, math.pi, n)
    return b


def _pairs(kind, seed=0):
    """(a, b) [N_BOX, 7] paired row by row."""
    rng = np.random.default_rng(seed)
    a = _random(rng, N_BOX)
    if kind == "random":
        b = _random(rng, N_BOX)
    elif kind == "identical":
        b = a.copy()
    elif kind == "rotated_duplicate":
        b = a.copy()
        b[:, 6] += math.pi
    elif kind == "disjoint":
        b = a.copy()
        b[:, 0] += 20.0
    elif kind == "edge_touching":
        # axis-aligned, b's left edge on a's right edge, half overlap in z
        a[:, 6] = 0.0
        b = a.copy()
        b[:, 0] += a[:, 4]
        b[:, 2] += 0.5 * a[:, 5]
    elif kind == "near_parallel":
        b = a.copy()
        b[:, 6] += 1e-6
        b[:, 0] += 0.4
        b[:, 2] += 0.7
    else:
        raise ValueError(kind)
    return a, b


KINDS = ["random", "identical", "rotated_duplicate", "disjoint",
         "edge_touching", "near_parallel"]


def _weights(n):
    return np.linspace(1.0, 2.0, n)


def _jax_f64(fn, a, b, pair):
    """Values and gradients of sum(w * fn(a, b)) under x64 (one jitted
    program per function and shape)."""
    with jax.enable_x64(True):
        w = _weights(a.shape[0])
        if pair:
            w = w[:, None] * _weights(b.shape[0])[None, :]
        val, (ga, gb) = _jax_value_and_grad(fn)(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(w))
        return np.asarray(val), np.asarray(ga), np.asarray(gb)


_JITTED = {}


def _jax_value_and_grad(fn):
    if fn not in _JITTED:
        def f(x, y, w):
            v = fn(x, y)
            return jnp.sum(v * w), v

        def vg(x, y, w):
            (_, v), g = jax.value_and_grad(f, argnums=(0, 1),
                                           has_aux=True)(x, y, w)
            return v, g

        _JITTED[fn] = jax.jit(vg)
    return _JITTED[fn]


def _torch(fn, a, b, pair, dtype):
    ta = torch.tensor(a, dtype=dtype, requires_grad=True)
    tb = torch.tensor(b, dtype=dtype, requires_grad=True)
    w = torch.tensor(_weights(a.shape[0]), dtype=dtype)
    if pair:
        w = w[:, None] * torch.tensor(_weights(b.shape[0]), dtype=dtype)
    val = fn(ta, tb)
    (val * w).sum().backward()
    return val.detach().numpy(), ta.grad.numpy(), tb.grad.numpy()


def _j_giou(a, b):
    return J.giou_3d(a, b)[0]


def _j_giou_iou(a, b):
    return J.giou_3d(a, b)[1]


FUNCS = {
    "iou_bev": (J.boxes_iou_bev, T.boxes_iou_bev, True),
    "iou3d": (J.boxes_iou3d, T.boxes_iou3d, True),
    "giou": (_j_giou, lambda a, b: T.giou_3d(a, b)[0], False),
    "giou_iou": (_j_giou_iou, lambda a, b: T.giou_3d(a, b)[1], False),
}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", sorted(FUNCS))
def test_float64_values_and_gradients_match_jax(name, kind):
    jf, tf, pair = FUNCS[name]
    a, b = _pairs(kind)
    want = _jax_f64(jf, a, b, pair)
    got = _torch(tf, a, b, pair, torch.float64)
    if kind in ("identical", "rotated_duplicate"):
        want = (want[0], want[1] + want[2])
        got = (got[0], got[1] + got[2])
    for g, w, what in zip(got, want, ("value", "d/da", "d/db")):
        assert np.isfinite(g).all(), what
        np.testing.assert_allclose(g, w, rtol=0, atol=F64_TOL,
                                   err_msg=f"{name} {kind} {what}")


@pytest.mark.parametrize("kind", KINDS)
def test_float32_values_match_and_gradients_are_finite(kind):
    a, b = _pairs(kind, seed=1)
    for name, (jf, tf, pair) in FUNCS.items():
        want = np.asarray(jax.jit(jf)(jnp.asarray(a, jnp.float32),
                                      jnp.asarray(b, jnp.float32)))
        got, ga, gb = _torch(tf, a, b, pair, torch.float32)
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL,
                                   err_msg=f"{name} {kind}")
        assert np.isfinite(ga).all() and np.isfinite(gb).all(), name


def test_known_values():
    """Identical axis-aligned boxes: IoU 1 and GIoU 1; a rotated box with
    itself: IoU 1 and GIoU below 1 (the axis-aligned hull, as the
    reference package has it); disjoint boxes: IoU 0, GIoU < 0."""
    box = torch.tensor([[0.0, 1.5, 10.0, 1.5, 1.6, 4.0, 0.0]],
                       dtype=torch.float64)
    g, i = T.giou_3d(box, box)
    assert float(i) == pytest.approx(1.0, abs=1e-12)
    assert float(g) == pytest.approx(1.0, abs=1e-12)
    rot = box.clone()
    rot[0, 6] = 0.5
    g, i = T.giou_3d(rot, rot)
    assert float(i) == pytest.approx(1.0, abs=1e-12) and float(g) < 1.0
    far = box.clone()
    far[0, 0] += 10.0
    g, i = T.giou_3d(box, far)
    assert float(i) == 0.0 and float(g) < 0.0
    assert float(T.boxes_iou3d(box, box)) == pytest.approx(1.0, abs=1e-12)


@pytest.mark.parametrize("thresh", [0.1, 0.5])
def test_nms_bev_indices_match_jax(thresh):
    """Random boxes with a rotated duplicate of each (so suppression
    fires) and more rounds than boxes survive: indices and valid flags
    equal."""
    rng = np.random.default_rng(7)
    a = _random(rng, 20)
    dup = a.copy()
    dup[:, 6] += 0.05
    boxes = np.concatenate([a, dup]).astype(np.float32)
    scores = rng.random(40).astype(np.float32)
    ji, jv = J.nms_bev(jnp.asarray(boxes), jnp.asarray(scores), thresh, 40)
    ti, tv = T.nms_bev(torch.from_numpy(boxes), torch.from_numpy(scores),
                       thresh, 40)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert 0 < int(tv.sum()) < 40


# ---------------------------------------------------------------------------
# the loss's 3D-projection and 3D-GIoU branches
# ---------------------------------------------------------------------------

CROP = (64, 128)
B = 2
# test_torch_loss.py's limits: float32 sums over a few thousand anchors
LOSS_TOL = dict(rtol=2e-5, atol=1e-6)
GRAD_TOL = 1e-5          # relative to the gradient's largest entry
P2 = np.array([[721.5377, 0.0, 609.5593, 44.85728],
               [0.0, 721.5377, 172.854, 0.2163791],
               [0.0, 0.0, 1.0, 0.002745884],
               [0.0, 0.0, 0.0, 1.0]])


@pytest.fixture(scope="module")
def setup():
    conf = __graft_entry__._flagship_conf(CROP, num_scales=2,
                                          backbone="dla34", dtype="float32")
    rois = j_locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    return conf, rois


def _case(N, seed):
    rng = np.random.default_rng(seed)
    cls_t = (rng.normal(size=(B, 4, N)) * 2).astype(np.float32)
    e = np.exp(cls_t - cls_t.max(1, keepdims=True))
    outputs = {
        "cls_t": cls_t,
        "prob_t": (e / e.sum(1, keepdims=True)).astype(np.float32),
        "lse": np.log(np.exp(cls_t.astype(np.float64)).sum(1)).astype(
            np.float32),
        "bbox_2d": (rng.normal(size=(B, 4, N)) * 0.5).astype(np.float32),
        "bbox_3d": (rng.normal(size=(B, 7, N)) * 0.5).astype(np.float32)}
    u = rng.uniform(size=(B, N))
    fg, ign = u < 0.03, u > 0.9
    labels = np.where(fg, rng.integers(1, 4, size=(B, N)), 0)
    labels = np.where(ign, 3000, labels).astype(np.int32)
    # targets near the predictions, so fg boxes overlap their targets
    tgt3d = outputs["bbox_3d"] + rng.normal(size=(B, 7, N)) * 0.1
    batch = {"labels": labels, "labels_fg": fg.astype(np.int8),
             "labels_bg": (~fg & ~ign).astype(np.int8),
             "labels_ign": ign.astype(np.int8),
             "bbox_2d": (rng.normal(size=(B, 4, N)) * 0.5).astype(
                 np.float32),
             "bbox_3d": tgt3d.astype(np.float32),
             "any_val": np.ones(B, np.int32),
             "p2_inv": np.stack([np.linalg.inv(P2)] * B).astype(np.float32)}
    return outputs, batch


def _consts(conf, rois):
    return (rois[:, :5].astype(np.float32),
            np.asarray(conf.anchors, np.float32),
            np.asarray(conf.bbox_means, np.float32),
            np.asarray(conf.bbox_stds, np.float32))


BRANCHES = [dict(bbox_3d_proj_lambda=1.0), dict(bbox_3d_iou_lambda=1.0),
            dict(bbox_3d_proj_lambda=0.5, bbox_3d_iou_lambda=2.0)]


@pytest.mark.parametrize("lams", BRANCHES, ids=["proj", "iou", "both"])
def test_loss_branches_match_jax(setup, lams):
    """Loss, every stat and d loss / d bbox_3d against JAX, each branch
    alone and both on."""
    conf, rois = setup
    N = rois.shape[0]
    outputs, batch = _case(N, 11)
    jcfg = JCfg.from_conf(conf).__class__(
        **{**JCfg.from_conf(conf).__dict__, **lams})
    tcfg = RPNLossConfig(**{k: v for k, v in jcfg.__dict__.items()
                            if k != "channel_major"})
    consts = _consts(conf, rois)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jf(bbox_3d):
        out = {k: jnp.asarray(v) for k, v in outputs.items()}
        out["bbox_3d"] = bbox_3d
        return j_rpn_3d_loss(out, jb, *[jnp.asarray(c) for c in consts],
                             jcfg)

    (jl, js), jg = jax.value_and_grad(jf, has_aux=True)(
        jnp.asarray(outputs["bbox_3d"]))
    tb3 = torch.tensor(outputs["bbox_3d"], requires_grad=True)
    tout = {k: torch.from_numpy(v) for k, v in outputs.items()}
    tout["bbox_3d"] = tb3
    tl, ts = rpn_3d_loss(tout, {k: torch.from_numpy(v)
                                for k, v in batch.items()},
                         *[torch.from_numpy(c) for c in consts], tcfg)
    tl.backward()
    assert sorted(ts) == sorted(js)
    for key, lam in (("loss_bbox3d_proj", "bbox_3d_proj_lambda"),
                     ("loss_bbox3d_iou", "bbox_3d_iou_lambda")):
        assert (key in ts) == bool(lams.get(lam)), key
    np.testing.assert_allclose(float(tl), float(jl), **LOSS_TOL)
    for k in js:
        np.testing.assert_allclose(float(ts[k]), float(js[k]), err_msg=k,
                                   **LOSS_TOL)
    jg = np.asarray(jg)
    assert np.abs(tb3.grad.numpy() - jg).max() / np.abs(jg).max() \
        < GRAD_TOL


def test_loss_branches_need_p2_inv(setup):
    """Without the batch's `p2_inv` the branches are skipped, as in the
    reference package: the loss equals the one with both lambdas at 0."""
    conf, rois = setup
    N = rois.shape[0]
    outputs, batch = _case(N, 12)
    del batch["p2_inv"]
    consts = [torch.from_numpy(c) for c in _consts(conf, rois)]
    tout = {k: torch.from_numpy(v) for k, v in outputs.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    on = RPNLossConfig.from_conf(conf.replace(bbox_3d_proj_lambda=1.0,
                                              bbox_3d_iou_lambda=1.0))
    off = RPNLossConfig.from_conf(conf)
    l_on, s_on = rpn_3d_loss(tout, tb, *consts, on)
    l_off, s_off = rpn_3d_loss(tout, tb, *consts, off)
    assert float(l_on) == float(l_off)
    assert sorted(s_on) == sorted(s_off)
    assert "loss_bbox3d_iou" not in s_on

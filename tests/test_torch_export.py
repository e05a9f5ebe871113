"""Export of the port's detector (`inference/export.py`), BatchNorm folding
(`utils/fold_bn.py`) against the JAX package's `fold_bn_eval` (which
takes the weights' parameter trees, written from the port's model), and
the shift-DCN custom op `m3dssd::dcn_shift` (`ops/dcn_op.py`).
"""

import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from m3dssd_tpu.inference.export import save_exported as j_save_exported
from m3dssd_tpu.utils.fold_bn import fold_bn_eval as j_fold_bn_eval
from m3dssd_tpu_torch.anchors import locate_anchors
from m3dssd_tpu_torch.config import flagship_conf
from m3dssd_tpu_torch.inference.detect import make_batch_detector
from m3dssd_tpu_torch.inference.export import (export_detector,
                                               load_detector, save_exported)
from m3dssd_tpu_torch.models import bias_background, build
from m3dssd_tpu_torch.ops import dcn_op
from m3dssd_tpu_torch.ops.dcn import dcn_v2_shift_reference
from m3dssd_tpu_torch.utils.fold_bn import fold_bn_eval
from m3dssd_tpu_torch.utils.torch_import import flax_path
from m3dssd_tpu_torch.utils.weights import from_flax_variables

# one torch thread per test process (see tests/test_torch_train.py)
torch.set_num_threads(1)

CROP = (64, 128)
B = 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOLD_TOL = 1e-6      # folded tensors, relative to each tensor's largest
DET_TOL = 1e-4       # folded against unfolded dets (float32 rounding)


def _flax_tree(model):
    """The JAX package's {"params", "batch_stats"} trees of `model`'s
    weights (the inverse of `from_flax_variables`)."""
    modules = dict(model.named_modules())
    tree = {"params": {}, "batch_stats": {}}
    for key, val in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        parts, leaf = flax_path(modules, key)
        a = val.numpy()
        if leaf == "kernel":
            a = a.transpose(2, 3, 1, 0)
            if parts[-1].startswith("ups_"):
                a = a[::-1, ::-1]
        node = tree["batch_stats" if leaf in ("mean", "var") else "params"]
        for p in parts:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(a)
    return tree


def _perturb_bn(model, seed):
    """Every BN leaf moved off its init, so an identity fold cannot
    pass."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n)))
                m.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, n)))
                m.bias.add_(torch.from_numpy(rng.normal(0, 0.2, n)))
                m.running_mean.add_(torch.from_numpy(rng.normal(0, 0.2, n)))
    return model


@pytest.fixture(scope="module")
def setup():
    conf = flagship_conf(CROP, num_scales=2, backbone="dla34",
                         dtype="float32")
    rois = locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    model = _perturb_bn(build(conf, device="cpu", seed=3), 3)
    tree = _flax_tree(model)
    images = np.random.default_rng(1).normal(
        size=(B,) + CROP + (3,)).astype(np.float32)
    return conf, rois, tree, model, images


def test_fold_bn_matches_jax(setup):
    """The same count of folded pairs, and every folded tensor within
    FOLD_TOL of JAX's folded tree through from_flax_variables."""
    conf, _, tree, model, _ = setup
    ref = from_flax_variables(tree)
    assert all(torch.equal(ref[k], v) for k, v in model.state_dict().items()
               if not k.endswith("num_batches_tracked"))
    jp, js, jn = j_fold_bn_eval(tree["params"], tree["batch_stats"])
    want = from_flax_variables({"params": jax.tree_util.tree_map(
        np.asarray, jp), "batch_stats": jax.tree_util.tree_map(
        np.asarray, js)})
    folded = build(conf, device="cpu")
    folded.load_state_dict(model.state_dict(), strict=True)
    n = fold_bn_eval(folded)
    assert n == jn > 0
    got = folded.state_dict()
    changed = 0
    for k, w in want.items():
        scale = max(float(w.abs().max()), 1e-12)
        assert float((got[k] - w).abs().max()) <= FOLD_TOL * scale, k
        changed += not torch.equal(w, model.state_dict()[k])
    assert changed >= 3 * n


def test_fold_bn_from_float32_masters_rounds_once(setup):
    """A bf16 eval build folded from the float32 weights it was cast from
    holds the float64 fold rounded once to bf16, as the export CLI folds a
    checkpoint; folding its own bf16 tensors rounds a second time."""
    _, _, _, model, _ = setup
    master = model.state_dict()
    conf16 = flagship_conf(CROP, num_scales=2, backbone="dla34",
                           dtype="bfloat16")
    m16 = build(conf16, device="cpu")
    m16.load_state_dict(master, strict=True)
    twice = build(conf16, device="cpu")
    twice.load_state_dict(master, strict=True)
    m64 = build(conf16, device="cpu").to(torch.float64)
    m64.load_state_dict(master, strict=True)
    n = fold_bn_eval(m16, master)
    assert n == fold_bn_eval(m64) == fold_bn_eval(twice) > 0
    got, want, other = m16.state_dict(), m64.state_dict(), twice.state_dict()
    assert all(torch.equal(got[k], want[k].to(got[k].dtype)) for k in got)
    assert any(not torch.equal(got[k], other[k]) for k in got)


def _dets_agree(got, want, tol):
    """Same valid rows and classes, boxes and scores within `tol` of the
    largest magnitude."""
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    assert got.shape == want.shape
    valid = want[..., 4] > 0
    assert torch.equal(got[..., 4] > 0, valid)
    assert torch.equal(got[..., 5][valid], want[..., 5][valid])
    scale = max(float(want[valid].abs().max()), 1.0) if valid.any() else 1.0
    err = float((got[valid] - want[valid]).abs().max()) if valid.any() \
        else 0.0
    assert err <= tol * scale, err


@pytest.mark.parametrize("bg_bias", [None, 4.0], ids=["dense", "sparse"])
def test_folded_detector_equals_unfolded(setup, bg_bias):
    conf, rois, _, model, images = setup
    m = build(conf, device="cpu")
    m.load_state_dict(model.state_dict(), strict=True)
    if bg_bias:
        bias_background(m, conf.num_classes, bg_bias)
    sfs = np.ones(B, np.float32)
    want = make_batch_detector(conf, rois, m, device="cpu")(images, sfs)
    assert fold_bn_eval(m) > 0
    got = make_batch_detector(conf, rois, m, device="cpu")(images, sfs)
    _dets_agree(got, want, DET_TOL)


@pytest.fixture(scope="module")
def artifact(setup, tmp_path_factory):
    """The batched detector exported on the CPU, saved and loaded."""
    conf, rois, _, model, _ = setup
    path = str(tmp_path_factory.mktemp("export") / "det.pt2")
    ep = export_detector(conf, rois, model, batch_size=B, device="cpu")
    save_exported(ep, path, conf=conf, batch_size=B)
    return path, ep


def test_exported_graph(setup, artifact):
    """8 calls of the custom op (the neck) and the align and pre-NMS
    switches as torch.cond, no Python-side branch baked in."""
    path, ep = artifact
    calls = [n for n in ep.graph.nodes if n.op == "call_function"]
    assert sum(str(n.target).startswith("m3dssd.dcn_shift")
               for n in calls) == 8
    assert sum("cond" in str(n.target) for n in calls) == 3
    with open(path + ".json") as f:
        meta = json.load(f)
    assert meta["platforms"] == ["cpu"]
    assert meta["in_avals"] == [f"float32[{B},{CROP[0]},{CROP[1]},3]",
                                f"float32[{B}]"]
    assert meta["out_avals"] == [f"float32[{B},40,14]"]


def test_sidecar_keys_match_jax(setup, artifact, tmp_path):
    conf, _, _, _, _ = setup
    path, _ = artifact
    stub = types.SimpleNamespace(serialize=lambda: b"x", platforms=("cpu",),
                                 in_avals=(), out_avals=())
    jpath = str(tmp_path / "det.shlo")
    j_save_exported(stub, jpath, conf=conf, batch_size=B)
    with open(jpath + ".json") as f, open(path + ".json") as g:
        assert sorted(json.load(f)) == sorted(json.load(g))


@pytest.mark.parametrize("bg_bias", [None, 4.0], ids=["dense", "sparse"])
def test_artifact_equals_eager(setup, artifact, bg_bias):
    """The loaded artifact against eager detect on the same weights, in
    both align regimes: a fresh model (every position confident, the
    dense align) and a background-biased one (the sparse align)."""
    conf, rois, _, model, images = setup
    path, _ = artifact
    m = model
    if bg_bias:
        m = build(conf, device="cpu")
        m.load_state_dict(model.state_dict(), strict=True)
        bias_background(m, conf.num_classes, bg_bias)
        ep = export_detector(conf, rois, m, batch_size=B, device="cpu")
        path = path + ".bg"
        save_exported(ep, path, conf=conf, batch_size=B)
    det = load_detector(path, device="cpu")
    sfs = np.array([1.0, 0.8], np.float32)
    want = make_batch_detector(conf, rois, m, device="cpu")(images, sfs)
    got = det(images, sfs)
    assert torch.equal(got, want)


def test_load_with_only_the_op_module(setup, artifact):
    """A process that imports only the op modules, ops/dcn_op.py and
    ops/nms_op.py, loads and runs the artifact."""
    conf, rois, _, model, images = setup
    path, _ = artifact
    np.save(path + ".images.npy", images)
    code = (
        "import sys, numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "import m3dssd_tpu_torch.ops.dcn_op, m3dssd_tpu_torch.ops.nms_op\n"
        "ep = torch.export.load(%r)\n"
        "x = torch.from_numpy(np.load(%r))\n"
        "out = ep.module()(x, torch.ones(x.shape[0]))\n"
        "np.save(%r, out.numpy())\n"
        "mods = [m for m in sys.modules if m.startswith('m3dssd')]\n"
        "print(sorted(mods))\n" % (path, path + ".images.npy",
                                   path + ".out.npy"))
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=os.path.dirname(path),
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "m3dssd_tpu'" not in res.stdout
    want = make_batch_detector(conf, rois, model, device="cpu")(
        images, np.ones(B, np.float32))
    assert torch.equal(torch.from_numpy(np.load(path + ".out.npy")), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_custom_op_opcheck(dtype):
    """The op's schema, fake (meta) implementation and dispatch hold under
    torch.library.opcheck, and its CPU kernel is the plain version."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 7, 8, generator=g).to(dtype)
    off = (torch.rand(2, 5, 7, 9, 2, generator=g) * 3 - 1.5)
    mask = torch.rand(2, 5, 7, 9, generator=g)
    w = (torch.randn(3, 3, 8, 6, generator=g) * 0.1).to(dtype)
    b = torch.randn(6, generator=g)
    for bias in (b, None):
        torch.library.opcheck(dcn_op.dcn_shift, (x, off, mask, w, bias, 1.0))
        out = dcn_op.dcn_shift(x, off, mask, w, bias, 1.0)
        assert out.dtype == dtype and out.shape == (2, 5, 7, 6)
        assert torch.equal(out, dcn_v2_shift_reference(x, off, mask, w, bias,
                                                       clamp=1.0))


def test_op_registration_is_guarded():
    """Importing a second copy of the op module (as a run's source
    snapshot does) leaves the one registration in place."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "dcn_op_copy", dcn_op.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.dcn_shift is dcn_op.dcn_shift


def test_bitmask_nms_fixpoint_exports():
    """The bitmask NMS's fixpoint (a while_loop under export) gives the
    eager indices, on boxes whose suppression chains need several
    rounds."""
    from m3dssd_tpu_torch.ops.nms import nms_bitmask_select_t

    class Nms(torch.nn.Module):
        def forward(self, boxes, scores):
            return nms_bitmask_select_t(boxes, scores, 0.3, 12)

    g = torch.Generator().manual_seed(0)
    xy = torch.rand(2, 2, 64, generator=g) * 40
    wh = torch.rand(2, 2, 64, generator=g) * 20 + 4
    boxes = torch.cat([xy, xy + wh], 1)
    scores = torch.rand(2, 64, generator=g)
    scores[1, ::3] = float("-inf")
    ep = torch.export.export(Nms(), (boxes, scores), strict=False)
    assert any("while_loop" in str(n.target) for n in ep.graph.nodes
               if n.op == "call_function")
    for seed in (1, 2):
        g.manual_seed(seed)
        b = torch.cat([xy, xy + wh], 1) + torch.rand(2, 4, 64, generator=g)
        s = torch.rand(2, 64, generator=g)
        want = nms_bitmask_select_t(b, s, 0.3, 12)
        got = ep.module()(b, s)
        assert all(torch.equal(x, y) for x, y in zip(got, want))

"""The port's sparse pre-NMS detectors and its batched KITTI test driver
against the JAX package, on the CPU, on the tiny flagship of
tests/test_torch_model.py (dla34, 2 anchor scales, float32) with shared,
perturbed weights.

The JAX detectors are built once per module and reused: their compile is
the cost of this file.
"""

import glob
import os

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from m3dssd_tpu.data import synthetic as j_synth
from m3dssd_tpu.data.kitti import Kitti3DDataset as JKitti3DDataset
from m3dssd_tpu.inference.detect import \
    make_batch_detector as j_make_batch_detector
from m3dssd_tpu.inference.detect import make_detector as j_make_detector
from m3dssd_tpu.inference.test_driver import test_kitti_3d as j_run_kitti_3d
from m3dssd_tpu.models import build as j_build
from m3dssd_tpu.models.dla import space_to_depth_np
from m3dssd_tpu_torch.anchors import locate_anchors
from m3dssd_tpu_torch.config import flagship_conf
from m3dssd_tpu_torch.data.kitti import Kitti3DDataset
from m3dssd_tpu_torch.eval.kitti_eval import evaluate_kitti
from m3dssd_tpu_torch.inference.detect import (_compact_positions,
                                               _sparse_nms_cfg,
                                               make_batch_detector,
                                               make_detector)
from m3dssd_tpu_torch.inference.test_driver import \
    test_kitti_3d as run_kitti_3d
from m3dssd_tpu_torch.models import build
from m3dssd_tpu_torch.utils.weights import from_flax_variables
from test_torch_model import _images, _perturb

CROP = (64, 224)
B = 2
DEEP = dict(rtol=1e-3, atol=1e-3)


def _confs(**over):
    jconf = __graft_entry__._flagship_conf(CROP, num_scales=2,
                                           backbone="dla34",
                                           dtype="float32").replace(**over)
    conf = flagship_conf(CROP, num_scales=2, backbone="dla34",
                         dtype="float32").replace(**over)
    return jconf, conf


@pytest.fixture(scope="module")
def flagship():
    """(JAX model, params, batch_stats, port model, rois) sharing weights."""
    jconf, conf = _confs()
    jmodel = j_build(jconf)
    x = np.zeros((1,) + CROP + (3,), np.float32)
    # jitted, the init compiles in a third of its eager time
    init = jax.jit(lambda key, x: jmodel.init(key, x, train=False))
    v = _perturb(init(jax.random.PRNGKey(0), x), 7)
    model = build(conf, device="cpu")
    model.load_state_dict(from_flax_variables(v), strict=True)
    rois = locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    return jmodel, v["params"], v["batch_stats"], model, rois


@pytest.fixture(scope="module")
def images():
    return space_to_depth_np(_images(21, (B,) + CROP + (3,)))


def _threshold(model, images, n_above):
    """A score threshold that about n_above anchors of each image clear."""
    with torch.inference_mode():
        scores = model(torch.from_numpy(images), packed=True)["scores"]
    return float(np.quantile(scores.numpy(), 1.0 - n_above / scores.shape[1]))


def _kept(dets, thresh):
    return dets[dets[..., 4] >= thresh]


@pytest.mark.parametrize("batched,bitmask", [(True, True), (False, False)])
def test_sparse_detectors_match_jax_and_dense(flagship, images, batched,
                                              bitmask):
    """With a threshold only a few positions clear, the sparse path runs:
    the port's dets match the JAX detector's within 1e-3 with the same
    survivors, and its above-threshold rows equal its dense path's."""
    jmodel, params, stats, model, rois = flagship
    thresh = _threshold(model, images, 30)
    jconf, conf = _confs(nms_sparse_topm=2048, score_thres=thresh,
                         nms_bitmask=bitmask)
    _, dense_conf = _confs(score_thres=thresh)
    m_pos, A, _ = _sparse_nms_cfg(conf, rois)
    with torch.inference_mode():
        scores = model(torch.from_numpy(images), packed=True)["scores"]
    assert bool(_compact_positions(scores, A, thresh, m_pos)[1].all())
    sfs = np.array([1.0, 0.8], np.float32)

    if batched:
        jdets = np.asarray(j_make_batch_detector(jconf, rois, jmodel,
                                                 packed_input=True)(
            params, stats, images, sfs))
        dets = make_batch_detector(conf, rois, model, packed_input=True,
                                   device="cpu")(images, sfs).numpy()
        dense = make_batch_detector(dense_conf, rois, model,
                                    packed_input=True,
                                    device="cpu")(images, sfs).numpy()
    else:
        jdet = j_make_detector(jconf, rois, jmodel, packed_input=True)
        det = make_detector(conf, rois, model, packed_input=True,
                            device="cpu")
        ddet = make_detector(dense_conf, rois, model, packed_input=True,
                             device="cpu")
        jdets = np.stack([np.asarray(jdet(params, stats, images[b:b + 1],
                                          sfs[b])) for b in range(B)])
        dets = np.stack([det(images[b:b + 1], sfs[b]).numpy()
                         for b in range(B)])
        dense = np.stack([ddet(images[b:b + 1], sfs[b]).numpy()
                          for b in range(B)])
    assert dets.shape == jdets.shape == (B, conf.nms_topN_post, 14)
    for b in range(B):
        k, jk, dk = (_kept(d[b], thresh) for d in (dets, jdets, dense))
        assert 0 < k.shape[0] == jk.shape[0] == dk.shape[0]
        np.testing.assert_array_equal(k[:, 13], jk[:, 13])
        np.testing.assert_array_equal(k[:, 5], jk[:, 5])
        np.testing.assert_allclose(k, jk, **DEEP)
        np.testing.assert_allclose(k, dk, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dets, jdets, **DEEP)


def test_sparse_overflow_falls_back_to_dense(flagship, images):
    """More confident positions than the budget: every image takes the
    dense path, so all rows equal the dense detector's, and the JAX
    detector's within 1e-3."""
    jmodel, params, stats, model, rois = flagship
    jconf, conf = _confs(nms_sparse_topm=8, score_thres=0.01)
    _, dense_conf = _confs(score_thres=0.01)
    sfs = np.ones(B, np.float32)
    dets = make_batch_detector(conf, rois, model, packed_input=True,
                               device="cpu")(images, sfs).numpy()
    dense = make_batch_detector(dense_conf, rois, model, packed_input=True,
                                device="cpu")(images, sfs).numpy()
    np.testing.assert_array_equal(dets, dense)
    single = make_detector(conf, rois, model, packed_input=True,
                           device="cpu")(images[:1], sfs[0]).numpy()
    single_dense = make_detector(dense_conf, rois, model, packed_input=True,
                                 device="cpu")(images[:1], sfs[0]).numpy()
    np.testing.assert_array_equal(single, single_dense)
    jdets = np.asarray(j_make_batch_detector(jconf, rois, jmodel,
                                             packed_input=True)(
        params, stats, images, sfs))
    np.testing.assert_array_equal(dets[..., 13], jdets[..., 13])
    np.testing.assert_allclose(dets, jdets, **DEEP)


# ---------------------------------------------------------------------------
# the whole driver
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti"))
    j_synth.generate(root, num_train=0, num_val=5, seed=4, imW=CROP[1],
                     imH=CROP[0], min_h_px=6)
    return root


# (batch size, packed input) of the driver runs
RUNS = [(1, False), (1, True), (2, False), (2, True)]


def _txts(path):
    files = sorted(glob.glob(os.path.join(path, "*.txt")))
    return {os.path.basename(f): open(f).read() for f in files}


@pytest.fixture(scope="module")
def driver_runs(flagship, split, tmp_path_factory):
    """Result dirs of the JAX driver and of the port's, each at batch size
    1 and 2, raw and packed, hill climbing off and a score threshold low
    enough that rows exist."""
    jmodel, params, stats, model, rois = flagship
    over = dict(hill_climbing=False, score_thres=0.2)
    jconf, conf = _confs(**over)
    out = tmp_path_factory.mktemp("results")
    gt = os.path.join(split, "kitti_split1", "validation", "label_2")
    jval = JKitti3DDataset(jconf, split, phase="validation")
    val = Kitti3DDataset(conf, split, phase="validation")
    dirs, sel = {}, {}
    # a CPU convolution sums in an order that depends on the batch size
    # under oneDNN and under several threads; the plain convolution on one
    # thread makes the port's CPU forward batch-invariant, as the JAX
    # package's is, so batch 1 and 2 can write the same bytes
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.backends.mkldnn.flags(enabled=False):
            _port_runs(conf, rois, model, val, gt, out, dirs, sel)
    finally:
        torch.set_num_threads(threads)
    for bs, packed in RUNS:
        d = str(out / f"jax_b{bs}_{'packed' if packed else 'raw'}")
        det = (j_make_detector(jconf, rois, jmodel, packed_input=packed)
               if bs == 1 else j_make_batch_detector(jconf, rois, jmodel,
                                                     packed_input=packed))
        j_run_kitti_3d(jval, det, params, stats, jconf, d, evaluate=False,
                       batch_size=bs, packed_input=packed)
        dirs[("jax", bs, packed)] = d
    return dirs, sel, gt, len(val)


def _port_runs(conf, rois, model, val, gt, out, dirs, sel):
    for bs, packed in RUNS:
        d = str(out / f"port_b{bs}_{'packed' if packed else 'raw'}")
        make = make_detector if bs == 1 else make_batch_detector
        det = make(conf, rois, model, packed_input=packed, device="cpu")
        res, sel[(bs, packed)] = run_kitti_3d(
            val, det, conf, d, gt_path=gt, batch_size=bs,
            packed_input=packed)
        assert "Car_3d_R40" in res
        dirs[("port", bs, packed)] = d


def test_driver_runs_agree_with_each_other(driver_runs):
    """The port's packed and raw runs, and its batch-1 and batch-2 runs,
    write byte-identical txts, one per image, with rows."""
    dirs, sel, _, n = driver_runs
    ref = _txts(dirs[("port", 1, False)])
    assert len(ref) == n
    rows = [len(t.splitlines()) for t in ref.values()]
    assert sum(rows) > 0
    for line in "".join(ref.values()).splitlines():
        assert len(line.split()) == 16
    for bs, packed in RUNS:
        assert _txts(dirs[("port", bs, packed)]) == ref
    assert len(set(sel.values())) == 1


@pytest.mark.parametrize("bs,packed", RUNS)
def test_driver_matches_jax(driver_runs, bs, packed):
    """The same files and row counts as the JAX driver, values within
    1e-3, and AP of the two result dirs within 1e-6."""
    dirs, _, gt, _ = driver_runs
    got, want = _txts(dirs[("port", bs, packed)]), _txts(dirs[("jax", bs,
                                                                 packed)])
    assert got.keys() == want.keys()
    for name in got:
        g = [line.split() for line in got[name].splitlines()]
        w = [line.split() for line in want[name].splitlines()]
        assert len(g) == len(w), name
        for gl, wl in zip(g, w):
            assert gl[:3] == wl[:3]
            np.testing.assert_allclose(np.asarray(gl[3:], float),
                                       np.asarray(wl[3:], float),
                                       rtol=1e-3, atol=1e-3, err_msg=name)
    ap = evaluate_kitti(gt, dirs[("port", bs, packed)])
    jap = evaluate_kitti(gt, dirs[("jax", bs, packed)])
    assert ap.keys() == jap.keys()
    for k in ap:
        if k != "_text":
            np.testing.assert_allclose(ap[k], jap[k], rtol=0, atol=1e-6)

"""The PyTorch port's ops and host modules against the JAX package.

Inputs are made with numpy from a seed and handed to both packages. The
port runs on the CPU here, through the plain PyTorch versions of its
ops; `test_torch_cuda.py` holds the hand-written kernel against them on
the card.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3dssd_tpu.anchors import locate_anchors as jax_locate_anchors
from m3dssd_tpu.ops import dcn as jdcn
from m3dssd_tpu.ops.boxes import bbox_transform_inv_t as j_bbox_inv_t
from m3dssd_tpu.ops.boxes import decode_bbox_3d_t as j_decode_3d_t
from m3dssd_tpu.ops.compact import first_m_true as j_first_m_true
from m3dssd_tpu.ops.dcn_pallas import dcn_v2_shift_pallas
from m3dssd_tpu.ops.nms import nms_select_t as j_nms_select_t
from m3dssd_tpu_torch.anchors import locate_anchors
from m3dssd_tpu_torch.config import flagship_conf
from m3dssd_tpu_torch.ops import dcn as tdcn
from m3dssd_tpu_torch.ops import dcn_cuda
from m3dssd_tpu_torch.ops.boxes import bbox_transform_inv_t, decode_bbox_3d_t
from m3dssd_tpu_torch.ops.compact import first_m_true
from m3dssd_tpu_torch.ops.nms import nms_select_t
from m3dssd_tpu_torch.utils.profiling import counts

# one torch thread per test process: the suite runs several workers at
# once, and torch's default of one thread per core made them
# oversubscribe the machine and slow every worker down
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# float32 on both sides; the products are summed in another order, so the
# tolerance allows a few ulps of the unit-scale sums
TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# config and anchors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("crop,scales", [((64, 128), 2), ((384, 1280), 12)])
def test_flagship_conf_and_anchors_match_jax(crop, scales):
    import __graft_entry__

    jconf = __graft_entry__._flagship_conf(crop, num_scales=scales,
                                           backbone="dla34", dtype="float32")
    conf = flagship_conf(crop, num_scales=scales, backbone="dla34",
                         dtype="float32")
    for name in ("anchors", "bbox_means", "bbox_stds"):
        np.testing.assert_array_equal(getattr(conf, name),
                                      getattr(jconf, name))
    assert conf.feat_size == jconf.feat_size
    for name in ("num_classes", "nms_topN_post", "nms_thres", "score_thres",
                 "sparse_align_topm", "dcn_shift_clamp", "attention",
                 "shape_align", "center_align", "ida_dcnv2"):
        assert getattr(conf, name) == getattr(jconf, name), name
    np.testing.assert_array_equal(
        locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride),
        jax_locate_anchors(jconf.anchors, jconf.feat_size,
                           jconf.feat_stride))


# ---------------------------------------------------------------------------
# deformable convolution
# ---------------------------------------------------------------------------

def _dcn_case(seed, B=2, H=6, W=11, C=8, Co=16, K=3, off_scale=0.8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    off = (rng.normal(size=(B, H, W, K * K, 2)) * off_scale).astype(np.float32)
    m = rng.random((B, H, W, K * K)).astype(np.float32)
    w = (rng.normal(size=(K, K, C, Co)) * 0.1).astype(np.float32)
    b = rng.normal(size=(Co,)).astype(np.float32)
    return x, off, m, w, b


@pytest.mark.parametrize("clamp", [1.0, 1.5])
def test_dcn_shift_reference_matches_jax_and_pallas(clamp):
    """The kernel's plain version equals the JAX op and the TPU kernel (in
    interpret mode). Offsets reach well past +-clamp, and a few sit exactly
    on it, so the clip is exercised on both sides."""
    x, off, m, w, b = _dcn_case(13, off_scale=1.2)
    off[0, 0, 0, 0] = (clamp, -clamp)
    want = np.asarray(jdcn.dcn_v2_shift(x, off, m, w, b, clamp=clamp))
    got = tdcn.dcn_v2_shift_reference(_t(x), _t(off), _t(m), _t(w), _t(b),
                                      clamp=clamp).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if clamp == 1.0:
        pallas = np.asarray(dcn_v2_shift_pallas(x, off, m, w, b, clamp=clamp,
                                                interpret=True))
        np.testing.assert_allclose(got, pallas, **TOL)
    # on a CPU tensor the public op is the plain version
    public = tdcn.dcn_v2_shift(_t(x), _t(off), _t(m), _t(w), _t(b),
                               clamp=clamp).numpy()
    np.testing.assert_array_equal(public, got)


def test_dcn_shift_equals_dcn_v2_inside_the_clamp():
    """With every |offset| <= clamp the shift form is bilinear sampling."""
    x, off, m, w, b = _dcn_case(5, off_scale=0.4)
    off = np.clip(off, -1.0, 1.0)
    shift = tdcn.dcn_v2_shift_reference(_t(x), _t(off), _t(m), _t(w), _t(b))
    gather = tdcn.dcn_v2(_t(x), _t(off), _t(m), _t(w), _t(b))
    np.testing.assert_allclose(shift.numpy(), gather.numpy(), **TOL)


@pytest.mark.parametrize("stride,padding,K", [(1, 1, 3), (2, 1, 3),
                                              (1, 0, 1)])
def test_dcn_v2_matches_jax_and_oracle(stride, padding, K):
    rng = np.random.default_rng(7)
    B, H, W, C, Co = 2, 7, 9, 3, 4
    Ho = (H + 2 * padding - K) // stride + 1
    Wo = (W + 2 * padding - K) // stride + 1
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    off = (rng.normal(size=(B, Ho, Wo, K * K, 2)) * 1.5).astype(np.float32)
    m = rng.uniform(0.2, 1.0, size=(B, Ho, Wo, K * K)).astype(np.float32)
    w = (rng.normal(size=(K, K, C, Co)) * 0.3).astype(np.float32)
    b = rng.normal(size=(Co,)).astype(np.float32)
    kw = dict(stride=stride, padding=padding)
    got = tdcn.dcn_v2(_t(x), _t(off), _t(m), _t(w), _t(b), **kw).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jdcn.dcn_v2(x, off, m, w, b, **kw)), **TOL)
    np.testing.assert_allclose(
        got, jdcn.dcn_v2_reference(x, off, m, w, b, **kw), **TOL)


def test_bilinear_sample_and_rows_match_jax():
    rng = np.random.default_rng(3)
    B, H, W, C, M, S = 2, 5, 6, 4, 7, 3
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    # points inside, on the border and well outside the map
    py = rng.uniform(-2.0, H + 1.0, size=(B, M, S)).astype(np.float32)
    px = rng.uniform(-2.0, W + 1.0, size=(B, M, S)).astype(np.float32)
    got = tdcn.bilinear_sample(_t(x), _t(py), _t(px)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jdcn.bilinear_sample(x, py, px)), **TOL)

    b_idx = rng.integers(0, B, size=(M,)).astype(np.int32)
    got = tdcn.bilinear_sample_rows(_t(x), _t(b_idx), _t(py[0]),
                                    _t(px[0])).numpy()
    want = np.asarray(jdcn.bilinear_sample_rows(x, b_idx, py[0], px[0]))
    np.testing.assert_allclose(got, want, **TOL)


def test_dcn_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    """Shapes, dtypes, layout and grad are checked before any launch; a
    CPU tensor is refused, never computed by the plain version."""
    x, off, m, w, b = (_t(a) for a in _dcn_case(1, B=1, H=3, W=4, C=2,
                                                Co=3))
    with pytest.raises(TypeError):
        dcn_cuda.dcn_v2_shift_cuda(x.double(), off, m, w.double(), b)
    with pytest.raises(TypeError):
        dcn_cuda.dcn_v2_shift_cuda(x, off, m, w.bfloat16(), b)
    with pytest.raises(ValueError):
        dcn_cuda.dcn_v2_shift_cuda(x, off[..., :4, :], m, w, b)
    with pytest.raises(ValueError):
        dcn_cuda.dcn_v2_shift_cuda(x.transpose(1, 2), off, m, w, b)
    with pytest.raises(ValueError):
        dcn_cuda.dcn_v2_shift_cuda(x, off, m, w, b, clamp=2.5)
    with pytest.raises(ValueError, match="requires grad"):
        dcn_cuda.dcn_v2_shift_cuda(x.requires_grad_(), off, m, w, b)
    launches = counts["dcn_shift.fwd"]
    with pytest.raises(ValueError, match="CUDA"):
        dcn_cuda.dcn_v2_shift_cuda(x.detach(), off, m, w, b)
    assert counts["dcn_shift.fwd"] == launches


# ---------------------------------------------------------------------------
# compaction, decode and NMS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("count,m", [(0, 5), (3, 5), (5, 5), (9, 5)])
def test_first_m_true_matches_jax(count, m):
    rng = np.random.default_rng(count)
    flags = np.zeros(40, bool)
    flags[rng.choice(40, size=count, replace=False)] = True
    idx, ok = first_m_true(_t(flags), m)
    jidx, jok = j_first_m_true(jnp.asarray(flags), m)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert bool(ok) == bool(jok) == (count <= m)


def test_box_decode_matches_jax():
    rng = np.random.default_rng(2)
    B, N = 2, 50
    xy = rng.uniform(0, 200, size=(2, N))
    wh = rng.uniform(5, 80, size=(2, N))
    rois = np.concatenate([xy, xy + wh, rng.integers(0, 3, (1, N))]
                          ).astype(np.float32)
    d2 = rng.normal(size=(B, 4, N)).astype(np.float32)
    d3 = rng.normal(size=(B, 7, N)).astype(np.float32)
    a3 = rng.uniform(1, 30, size=(5, N)).astype(np.float32)
    means = rng.normal(size=(11,)).astype(np.float32) * 0.1
    stds = rng.uniform(0.1, 0.5, size=(11,)).astype(np.float32)
    np.testing.assert_allclose(
        bbox_transform_inv_t(_t(rois), _t(d2), _t(means[:4]),
                             _t(stds[:4])).numpy(),
        np.asarray(j_bbox_inv_t(rois, d2, means[:4], stds[:4])), rtol=1e-5)
    np.testing.assert_allclose(
        decode_bbox_3d_t(_t(rois), _t(d3), _t(a3), _t(means),
                         _t(stds)).numpy(),
        np.asarray(j_decode_3d_t(rois, d3, a3, means, stds)), rtol=1e-5)


@pytest.mark.parametrize("stop_below", [None, 0.5, 2.0])
def test_batched_nms_equals_per_image_jax(stop_below):
    """The B images' rounds run together and give per-image greedy NMS;
    an image whose scores run out early pads with index 0."""
    rng = np.random.default_rng(4)
    B, N, K = 3, 120, 25
    xy = rng.uniform(0, 100, size=(B, 2, N))
    wh = rng.uniform(5, 40, size=(B, 2, N))
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    scores = rng.random((B, N)).astype(np.float32)
    scores[1] *= 0.6              # image 1 stops earlier at stop_below=0.5
    idx, valid = nms_select_t(_t(boxes), _t(scores), 0.4, K,
                              stop_below=stop_below)
    for b in range(B):
        jidx, jvalid = j_nms_select_t(jnp.asarray(boxes[b]),
                                      jnp.asarray(scores[b]), 0.4, K,
                                      stop_below=stop_below)
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(valid[b].numpy(), np.asarray(jvalid))
    single = nms_select_t(_t(boxes[0]), _t(scores[0]), 0.4, K,
                          stop_below=stop_below)
    np.testing.assert_array_equal(single[0].numpy(), idx[0].numpy())


# ---------------------------------------------------------------------------
# package boundary
# ---------------------------------------------------------------------------

def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import m3dssd_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' "
        "or k.startswith('jax.') or k == 'm3dssd_tpu' "
        "or k.startswith('m3dssd_tpu.'))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 20, names\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr

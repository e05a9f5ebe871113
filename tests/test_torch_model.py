"""The PyTorch port's modules, model and detector against the JAX package.

Every test here builds the JAX side, perturbs its initial weights from a
numpy seed (so that BN statistics, the upsampling kernels' flip and the
deformable offsets are all exercised), loads the same weights into the
port through `from_flax_variables`, and compares in float32 on the CPU.
The whole-model tests live in this one file so that `--dist loadfile`
gives them one worker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from m3dssd_tpu.anchors import locate_anchors as j_locate_anchors
from m3dssd_tpu.inference.detect import \
    make_batch_detector as j_make_batch_detector
from m3dssd_tpu.models import build as j_build
from m3dssd_tpu.models.align import CenterAlign as JCenterAlign
from m3dssd_tpu.models.align import ShapeAlign as JShapeAlign
from m3dssd_tpu.models.align import confident_topm as j_confident_topm
from m3dssd_tpu.models.attention import ANAB as JANAB
from m3dssd_tpu.models.dla import space_to_depth_np
from m3dssd_tpu.models.necks import DLASeg as JDLASeg
from m3dssd_tpu.models.rpn import bias_background as j_bias_background
from m3dssd_tpu_torch.anchors import locate_anchors
from m3dssd_tpu_torch.config import flagship_conf
from m3dssd_tpu_torch.inference.detect import (make_batch_detector,
                                               make_detector)
from m3dssd_tpu_torch.models import bias_background, build
from m3dssd_tpu_torch.models.align import (CenterAlign, ShapeAlign,
                                           confident_topm)
from m3dssd_tpu_torch.models.attention import ANAB
from m3dssd_tpu_torch.models.necks import DCN, DLASeg
from m3dssd_tpu_torch.utils.weights import from_flax_variables

# one torch thread per test process: the suite runs several workers at
# once, and torch's default of one thread per core made them
# oversubscribe the machine and slow every worker down
torch.set_num_threads(1)

CROP = (64, 128)
B = 2
# float32 through a deep chain of convolutions summed in another order
DEEP = dict(rtol=1e-3, atol=1e-3)
SHALLOW = dict(rtol=1e-4, atol=1e-4)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb(variables, seed: int):
    """Move every zero or constant initial value off its default: BN
    scale/bias/mean/var, biases, the zero-initialised DCN offset/mask
    convs (so neck offsets are fractional and some pass +-1) and the
    symmetric bilinear upsampling kernels (so a missing flip shows)."""
    rng = np.random.default_rng(seed)

    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            p = path + (k,)
            if hasattr(v, "items"):
                out[k] = walk(v, p)
                continue
            a = np.array(v, np.float32)
            name = k
            if "conv_offset_mask" in p and name == "kernel":
                fan_in = a.shape[0] * a.shape[1] * a.shape[2]
                a = rng.normal(size=a.shape) * (3.0 / np.sqrt(fan_in))
            elif "conv_offset_mask" in p and name == "bias":
                a = rng.normal(size=a.shape) * 0.3
            elif name == "kernel" and any(s.startswith("ups_") for s in p):
                a = a + rng.uniform(-0.1, 0.1, size=a.shape)
            elif name == "scale":
                a = rng.uniform(0.8, 1.2, size=a.shape)
            elif name == "bias":
                a = a + rng.normal(size=a.shape) * 0.05
            elif name == "mean":
                a = rng.normal(size=a.shape) * 0.1
            elif name == "var":
                a = rng.uniform(0.5, 1.5, size=a.shape)
            out[k] = a.astype(np.float32)
        return out

    return walk(_np_tree(variables), ())


def _load(module, variables):
    module.load_state_dict(from_flax_variables(variables), strict=True)
    return module.eval()


def _images(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_dcn", [True, False])
@pytest.mark.parametrize("packed", [False, True])
def test_dlaseg_matches_jax(use_dcn, packed):
    images = _images(0, (B,) + CROP + (3,))
    inp = space_to_depth_np(images) if packed else images
    jmod = JDLASeg(base_name="dla34", use_dcn=use_dcn, shift_clamp=1.0)
    variables = _perturb(jmod.init(jax.random.PRNGKey(0), images,
                                   train=False), 1)
    want = np.asarray(jmod.apply(variables, inp, train=False, packed=packed))

    mod = _load(DLASeg("dla34", use_dcn=use_dcn, shift_clamp=1.0), variables)
    if use_dcn:
        assert sum(m.uses_shift for m in mod.modules()
                   if isinstance(m, DCN)) == 8
    with torch.inference_mode():
        got = mod(torch.from_numpy(inp), packed=packed)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **DEEP)


def test_neck_offsets_reach_past_the_clamp():
    """The perturbed offset convs give fractional offsets, some beyond
    +-1, so the DLASeg test above runs the clip and the triangle weights."""
    images = _images(0, (B,) + CROP + (3,))
    jmod = JDLASeg(base_name="dla34", use_dcn=True, shift_clamp=1.0)
    variables = _perturb(jmod.init(jax.random.PRNGKey(0), images,
                                   train=False), 1)
    mod = _load(DLASeg("dla34", use_dcn=True, shift_clamp=1.0), variables)
    seen = []
    hook = lambda m, args, out: seen.append(out[:, :18].abs().flatten())
    for m in mod.modules():
        if isinstance(m, DCN):
            m.conv_offset_mask.register_forward_hook(hook)
    with torch.inference_mode():
        mod(torch.from_numpy(images))
    off = torch.cat(seen)
    assert len(seen) == 8
    assert 0.05 < float((off > 1.0).float().mean()) < 0.95
    assert float((off.frac() != 0).float().mean()) > 0.99


def test_dla102_neck_has_eight_shift_dcn_layers():
    """The flagship neck launches the kernel 8 times per forward; the JAX
    DLASeg(dla102) declares the same 8 DCN layers."""
    with torch.device("meta"):
        mod = DLASeg("dla102", use_dcn=True, shift_clamp=1.0)
    shift = [n for n, m in mod.named_modules()
             if isinstance(m, DCN) and m.uses_shift]
    assert len(shift) == 8
    shapes = jax.eval_shape(
        lambda x: JDLASeg(base_name="dla102").init(jax.random.PRNGKey(0), x,
                                                   train=False),
        jax.ShapeDtypeStruct((1, 64, 128, 3), jnp.float32))
    jax_dcn = [k for k, _ in jax.tree_util.tree_flatten_with_path(
        shapes["params"])[0] if "DCN_0" in jax.tree_util.keystr(k)
        and "'weight'" in jax.tree_util.keystr(k)]
    assert len(jax_dcn) == 8


def test_anab_matches_jax():
    x = _images(2, (B, 20, 36, 32))
    jmod = JANAB()
    variables = _perturb(jmod.init(jax.random.PRNGKey(1), x), 3)
    want = np.asarray(jmod.apply(variables, x))
    mod = _load(ANAB(32), variables)
    with torch.inference_mode():
        got = mod(_nchw(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               **SHALLOW)


def _align_inputs(confident, seed=0, Bn=2, H=10, W=12, C=16, A=4):
    rng = np.random.default_rng(seed)
    prob = rng.uniform(0.01, 0.3, size=(Bn, H, W, A)).astype(np.float32)
    for p in rng.choice(Bn * H * W, size=confident, replace=False):
        b, r = divmod(int(p), H * W)
        prob[b, r // W, r % W, rng.integers(0, A)] = rng.uniform(0.6, 0.95)
    w = rng.uniform(16, 120, A)
    h = rng.uniform(16, 120, A)
    anchors = np.stack([-w / 2, -h / 2, w / 2, h / 2], axis=1)
    x = rng.normal(size=(Bn, H, W, C)).astype(np.float32)
    bx = rng.normal(size=(Bn, H, W, A)).astype(np.float32)
    by = rng.normal(size=(Bn, H, W, A)).astype(np.float32)
    return x, prob, anchors.astype(np.float32), bx, by


# (confident positions, per-image budget): sparse with hits, sparse with
# none, and an overflow that falls back to the dense path
ALIGN_REGIMES = [(7, 8), (0, 8), (30, 4), (None, None)]


@pytest.mark.parametrize("confident,m", ALIGN_REGIMES)
def test_shape_align_matches_jax(confident, m):
    dense = confident is None
    x, prob, anchors, _, _ = _align_inputs(5 if dense else confident)
    jmod = JShapeAlign(16, anchors, 8, kernel=3)
    variables = _perturb(jmod.init(jax.random.PRNGKey(2), x, prob), 4)
    jsel = None if dense else j_confident_topm(prob, 0.5, m)
    want = np.asarray(jmod.apply(variables, x, prob, sparse_sel=jsel))

    mod = _load(ShapeAlign(16, anchors, 8, 3), variables)
    tprob = torch.from_numpy(prob)
    sel = None if dense else confident_topm(tprob, 0.5, m)
    if not dense:
        assert sel.ok == bool(jsel.ok) == (confident <= m * 2)
    with torch.inference_mode():
        got = mod(_nchw(x), tprob, sparse_sel=sel)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               **SHALLOW)


@pytest.mark.parametrize("confident,m", ALIGN_REGIMES)
def test_center_align_matches_jax(confident, m):
    dense = confident is None
    x, prob, anchors, bx, by = _align_inputs(5 if dense else confident)
    mean, std = np.array([0.1, -0.2]), np.array([0.3, 0.4])
    jmod = JCenterAlign(16, anchors, mean, std, 8)
    variables = _perturb(jmod.init(jax.random.PRNGKey(3), x, bx, by, prob),
                         5)
    jsel = None if dense else j_confident_topm(prob, 0.5, m)
    want = np.asarray(jmod.apply(variables, x, bx, by, prob,
                                 sparse_sel=jsel))

    mod = _load(CenterAlign(16, anchors, mean, std, 8), variables)
    tprob = torch.from_numpy(prob)
    sel = None if dense else confident_topm(tprob, 0.5, m)
    with torch.inference_mode():
        got = mod(_nchw(x), torch.from_numpy(bx), torch.from_numpy(by),
                  tprob, sparse_sel=sel)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               **SHALLOW)


# ---------------------------------------------------------------------------
# the whole slice: eval forward and batched detect
# ---------------------------------------------------------------------------

def _confs(**over):
    jconf = __graft_entry__._flagship_conf(CROP, num_scales=2,
                                           backbone="dla34",
                                           dtype="float32").replace(**over)
    conf = flagship_conf(CROP, num_scales=2, backbone="dla34",
                         dtype="float32").replace(**over)
    return jconf, conf


@pytest.fixture(scope="module")
def flagship_variables():
    jconf, _ = _confs()
    x = np.zeros((1,) + CROP + (3,), np.float32)
    variables = j_build(jconf).init(jax.random.PRNGKey(0), x, train=False)
    return _perturb(variables, 7)


# regime -> (config overrides, background bias, fraction of confident
# positions expected: "all", "none" or "some")
REGIMES = {
    "fresh": ({}, None, "all"),
    "background": ({}, 4.0, "none"),
    "overflow": ({"sparse_align_topm": 4}, 1.25, "some"),
    "all_rounds": ({"nms_score_stop": False}, None, "all"),
}


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_flagship_forward_and_dets_match_jax(flagship_variables, regime):
    over, bias, confident = REGIMES[regime]
    jconf, conf = _confs(**over)
    jmodel = j_build(jconf)
    params = flagship_variables["params"]
    stats = flagship_variables["batch_stats"]
    model = build(conf, device="cpu")
    model.load_state_dict(from_flax_variables(flagship_variables),
                          strict=True)
    if bias is not None:
        params = j_bias_background(params, jconf.num_classes, bias)
        bias_background(model, conf.num_classes, bias)

    images = space_to_depth_np(_images(11, (B,) + CROP + (3,)))
    sfs = np.array([1.0, 0.8], np.float32)

    jout = jax.jit(lambda p, s, x: jmodel.apply(
        {"params": p, "batch_stats": s}, x, train=False, packed=True))(
            params, stats, images)
    with torch.inference_mode():
        out = model(torch.from_numpy(images), packed=True)
    assert out["feat_size"] == tuple(jout["feat_size"])
    for k in ("cls", "prob", "cls_t", "prob_t", "lse", "scores", "cls_pred",
              "bbox_2d", "bbox_3d"):
        assert out[k].dtype == torch.float32, k
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   err_msg=k, **DEEP)

    fg = 1.0 - out["prob_t"][:, 0].reshape(B, -1, conf.anchors.shape[0])
    frac = float((fg.max(-1).values > model.align_thresh).float().mean())
    assert {"all": frac == 1.0, "none": frac == 0.0,
            "some": 0.0 < frac < 1.0}[confident], frac
    if regime == "overflow":
        M = conf.sparse_align_topm * B
        assert frac * out["scores"].shape[1] / conf.anchors.shape[0] * B > M

    rois = locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    np.testing.assert_array_equal(
        rois, j_locate_anchors(jconf.anchors, jconf.feat_size,
                               jconf.feat_stride))
    jdets = np.asarray(j_make_batch_detector(jconf, rois, jmodel,
                                             packed_input=True)(
        params, stats, images, sfs))
    dets = make_batch_detector(conf, rois, model, packed_input=True,
                               device="cpu")(images, sfs).numpy()
    assert dets.shape == jdets.shape == (B, conf.nms_topN_post, 14)
    # the same survivors: anchor index, class and validity agree exactly
    np.testing.assert_array_equal(dets[..., 13], jdets[..., 13])
    np.testing.assert_array_equal(dets[..., 5], jdets[..., 5])
    np.testing.assert_array_equal(dets[..., 4] < 0, jdets[..., 4] < 0)
    np.testing.assert_allclose(dets, jdets, **DEEP)
    if regime == "all_rounds":
        assert (dets[..., 4] > 0).all()


def test_single_image_detector_with_topk_pre_and_clipping(
        flagship_variables):
    """make_detector's top-k pre-NMS cut and the post-NMS clip agree with
    the batched detector run on the same top-k scores."""
    _, conf = _confs(nms_score_stop=False, clip_boxes=True, nms_topN_pre=50)
    model = build(conf, device="cpu")
    model.load_state_dict(from_flax_variables(flagship_variables),
                          strict=True)
    rois = locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    image = _images(12, (1,) + CROP + (3,))
    dets = make_detector(conf, rois, model, use_topk_pre=True,
                         device="cpu")(image, 0.5).numpy()
    full = make_detector(conf, rois, model, device="cpu")(image, 0.5).numpy()
    assert dets.shape == (conf.nms_topN_post, 14)
    im_h, im_w = CROP[0] / 0.5 - 1.0, CROP[1] / 0.5 - 1.0
    for d in (dets, full):
        assert (d[:, [0, 2]] >= 0).all() and (d[:, [0, 2]] <= im_w).all()
        assert (d[:, [1, 3]] >= 0).all() and (d[:, [1, 3]] <= im_h).all()
    # the top-k cut keeps the best-scoring anchors, so the first survivor
    # (the global best) is the same
    np.testing.assert_allclose(dets[0], full[0], rtol=1e-6)


def test_entry_points_refuse_to_guess_the_cpu():
    """Without device="cpu" the entry points ask for the card and raise on
    a machine without one."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    _, conf = _confs()
    with pytest.raises(RuntimeError, match="CUDA"):
        build(conf)
    model = build(conf, device="cpu")
    rois = locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_batch_detector(conf, rois, model)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_detector(conf, rois, model)

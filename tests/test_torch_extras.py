"""The grab-bag modules of the port (`models/extras.py`, `losses/extras.py`,
`ops/psroi.py`, `ops/roipool3d.py`, `utils/drawing.py`) against the JAX
package's, on the same seeded numpy inputs: float64 within 1e-10
relative (JAX under `jax.enable_x64`), float32 within 1e-5. Modules carry
the flax weights across through `utils/weights.py:from_flax_variables`
(the tolerance is relative to each value and to the array's largest).
The random initialisers draw from different streams in the two
frameworks, so they are held to the reference's statistics (mean, std,
bound) on the same shapes; `drawing` needs OpenCV and skips without it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3dssd_tpu.losses import extras as j_losses
from m3dssd_tpu.models import extras as j_extras
from m3dssd_tpu.ops.psroi import dcn_v2_psroi_pooling as j_psroi
from m3dssd_tpu.ops import roipool3d as j_roi
from m3dssd_tpu_torch.losses import extras as losses
from m3dssd_tpu_torch.models import extras
from m3dssd_tpu_torch.ops.psroi import dcn_v2_psroi_pooling
from m3dssd_tpu_torch.ops import roipool3d
from m3dssd_tpu_torch.utils.weights import from_flax_variables

torch.set_num_threads(1)

# relative to each value, and to the largest value of the array
TOL = {np.float32: 1e-5, np.float64: 1e-10}
DTYPES = [np.float32, np.float64]


def _close(got, want, dtype):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL[dtype],
                               atol=TOL[dtype] * scale)


def _x64(dtype):
    return jax.enable_x64(dtype == np.float64)


def _load(module, variables):
    sd = from_flax_variables({"params": variables["params"],
                              "batch_stats": variables.get("batch_stats",
                                                           {})})
    module.load_state_dict(sd, strict=True)
    return module


# ---------------------------------------------------------------------------
# models/extras.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_box_utils_match_jax(dtype):
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 300, size=(20, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 80, size=(20, 2))],
                           axis=1).astype(dtype)
    deltas = rng.normal(size=(20, 4)).astype(dtype)
    with _x64(dtype):
        want = j_extras.bbox_transform_retina(jnp.asarray(boxes),
                                              jnp.asarray(deltas),
                                              mean=(0.1, 0, 0, 0.2))
        wclip = j_extras.clip_boxes(want, 200, 250)
    got = extras.bbox_transform_retina(torch.from_numpy(boxes),
                                       torch.from_numpy(deltas),
                                       mean=(0.1, 0, 0, 0.2))
    _close(got, want, dtype)
    _close(extras.clip_boxes(got, 200, 250), wclip, dtype)


def test_numpy_anchor_helpers_equal_jax():
    a = extras.retina_generate_anchors(32, np.array([0.5, 1.0]),
                                       np.array([1.0, 1.5]))
    np.testing.assert_array_equal(
        a, j_extras.retina_generate_anchors(32, np.array([0.5, 1.0]),
                                            np.array([1.0, 1.5])))
    np.testing.assert_array_equal(extras.shift_anchors((3, 5), 8, a),
                                  j_extras.shift_anchors((3, 5), 8, a))
    np.testing.assert_array_equal(
        extras.anchors_for_shape((64, 100), pyramid_levels=(3, 4, 5)),
        j_extras.anchors_for_shape((64, 100), pyramid_levels=(3, 4, 5)))


@pytest.mark.parametrize("head", ["regression", "classification"])
def test_retina_heads_match_jax(head):
    x = np.random.default_rng(1).normal(size=(2, 6, 7, 16)).astype(
        np.float32)
    if head == "regression":
        jm = j_extras.RetinaRegressionHead(num_anchors=3, feature_size=32)
        m = extras.RetinaRegressionHead(16, num_anchors=3, feature_size=32)
    else:
        jm = j_extras.RetinaClassificationHead(num_anchors=3, num_classes=5,
                                               feature_size=32)
        m = extras.RetinaClassificationHead(16, num_anchors=3,
                                            num_classes=5, feature_size=32)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jm.apply(v, jnp.asarray(x))
    got = _load(m, v)(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    _close(got, want, np.float32)
    if head == "classification":
        # the prior bias: the fresh port head's constant before the towers
        fresh = extras.RetinaClassificationHead(16, num_classes=5)
        np.testing.assert_allclose(fresh.Conv_4.bias.detach().numpy(),
                                   extras.bias_init_with_prob(0.01),
                                   rtol=1e-6)


CONV_MODULE_CASES = [("conv", "bn", "relu"), ("conv_ws", "gn", "leaky"),
                     ("conv", None, None)]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("conv_type,norm,act", CONV_MODULE_CASES)
def test_conv_module_matches_jax(conv_type, norm, act, train):
    """Every case of tests/test_extras_modules.py's parametrisation, in
    eval and train mode (BN's batch statistics and running-statistics
    update), with the flax weights carried across."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
    jm = j_extras.ConvModule(features=32, stride=2, conv_type=conv_type,
                             norm=norm, act=act, gn_groups=8)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    v = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32), v)
    if train:
        want, upd = jm.apply(v, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    else:
        want = jm.apply(v, jnp.asarray(x), train=False)
    m = _load(extras.ConvModule(16, 32, stride=2, conv_type=conv_type,
                                norm=norm, act=act, gn_groups=8), v)
    got = m(torch.from_numpy(x), train=train)
    _close(got, want, np.float32)
    if train and norm == "bn":
        bs = upd["batch_stats"]["BatchNorm_0"]
        _close(m.BatchNorm_0.running_mean, bs["mean"], np.float32)
        _close(m.BatchNorm_0.running_var, bs["var"], np.float32)


def test_conv_module_norm_before_conv_matches_jax():
    """order ("norm", "act", "conv"): the norm takes the input's channels."""
    x = np.random.default_rng(3).normal(size=(2, 6, 6, 16)).astype(
        np.float32)
    order = ("norm", "act", "conv")
    jm = j_extras.ConvModule(features=8, norm="gn", act="relu", gn_groups=4,
                             order=order)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False)
    m = _load(extras.ConvModule(16, 8, norm="gn", act="relu", gn_groups=4,
                                order=order), v)
    _close(m(torch.from_numpy(x), train=False),
           jm.apply(v, jnp.asarray(x), train=False), np.float32)


@pytest.mark.parametrize("kind", ["conv_ws", "same_padding"])
def test_standalone_convs_match_jax(kind):
    """ConvWS (the population std) and the 'SAME' conv at stride 2 on odd
    sizes (the extra padding row and column at the bottom and right)."""
    x = np.random.default_rng(4).normal(size=(1, 7, 9, 3)).astype(np.float32)
    if kind == "conv_ws":
        jm = j_extras.ConvWS(features=4, kernel=3, stride=2)
        m = extras.ConvWS(3, 4, kernel=3, stride=2)
        v = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
        got = _load(m, v)(torch.from_numpy(x).permute(0, 3, 1, 2))
        got = got.permute(0, 2, 3, 1)
    else:
        jm = j_extras.Conv2dSamePadding(features=4, kernel=3, stride=2)
        m = extras.Conv2dSamePadding(3, 4, kernel=3, stride=2)
        v = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
        got = _load(m, v)(torch.from_numpy(x))
    want = jm.apply(v, jnp.asarray(x))
    assert tuple(got.shape) == want.shape
    _close(got, want, np.float32)


def test_swish_round_filters_and_prior_match_jax():
    x = np.linspace(-6, 6, 25)
    with jax.enable_x64(True):
        want = j_extras.swish(jnp.asarray(x))
    _close(extras.swish(torch.from_numpy(x)), want, np.float64)
    for f, w, d, md in [(32, None, 8, None), (32, 1.5, 8, None),
                        (40, 1.1, 8, 16), (3, 0.3, 8, None)]:
        assert extras.round_filters(f, w, d, md) == \
            j_extras.round_filters(f, w, d, md)
    for p in (0.01, 0.2, 0.5):
        assert extras.bias_init_with_prob(p) == j_extras.bias_init_with_prob(p)


def test_drop_connect_statistics_match_jax():
    """Each sample kept with probability 1 - rate and scaled by its
    inverse: the kept share of 4096 samples within 4 binomial sigmas of
    JAX's, the values {0, 1 / keep}; deterministic or rate 0 is the
    identity."""
    n, rate = 4096, 0.3
    x = np.ones((n, 2, 2, 1), np.float32)
    want = np.asarray(j_extras.drop_connect(jnp.asarray(x),
                                            jax.random.PRNGKey(0), rate,
                                            False))
    got = extras.drop_connect(torch.from_numpy(x),
                              torch.Generator().manual_seed(0), rate,
                              False).numpy()
    for y in (want, got):
        vals = np.unique(y)
        assert len(vals) == 2 and vals[0] == 0.0
        np.testing.assert_allclose(vals[1], 1 / (1 - rate), rtol=1e-6)
        assert np.all(y == y[:, :1, :1])          # one draw per sample
    sigma = np.sqrt(n * rate * (1 - rate))
    assert abs((got[:, 0, 0, 0] > 0).sum() - (want[:, 0, 0, 0] > 0).sum()) \
        <= 4 * sigma * np.sqrt(2)
    t = torch.from_numpy(x)
    assert extras.drop_connect(t, None, rate, True) is t
    assert extras.drop_connect(t, None, 0.0, False) is t


@pytest.mark.parametrize("fn,kw", [
    ("xavier_init", {}), ("xavier_init", {"distribution": "uniform",
                                          "gain": 2.0}),
    ("kaiming_init", {}), ("kaiming_init", {"mode": "fan_in", "a": 0.1,
                                            "distribution": "uniform"})])
def test_initialisers_match_jax_statistics(fn, kw):
    """On the reference's HWIO fan rule: mean, std and (uniform) bound of
    the port's draws against JAX's on the same shape, each within a few
    standard errors of the other."""
    shape = (3, 3, 64, 96)
    want = np.asarray(getattr(j_extras, fn)(jax.random.PRNGKey(0), shape,
                                            **kw))
    got = getattr(extras, fn)(torch.Generator().manual_seed(0), shape,
                              **kw).numpy()
    assert got.shape == want.shape
    n = got.size
    std = want.std()
    assert abs(got.mean() - want.mean()) <= 6 * std / np.sqrt(n)
    assert abs(got.std() - std) <= 6 * std / np.sqrt(n)
    if kw.get("distribution") == "uniform":
        bound = np.abs(want).max()
        assert np.abs(got).max() <= bound * (1 + 1e-3)
        assert np.abs(got).max() >= bound * 0.99


# ---------------------------------------------------------------------------
# losses/extras.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_classification_losses_match_jax(dtype):
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=(6, 50)) * 4).astype(dtype)
    targets = (rng.uniform(size=(6, 50)) < 0.3).astype(dtype)
    weights = rng.uniform(size=(6, 50)).astype(dtype)
    t = [torch.from_numpy(a) for a in (logits, targets, weights)]
    with _x64(dtype):
        j = [jnp.asarray(a) for a in (logits, targets, weights)]
        want = [j_losses.sigmoid_focal_loss(*j[:2]),
                j_losses.sigmoid_focal_loss(*j, gamma=1.5, alpha=0.4),
                j_losses.dice_loss(*j[:2])]
    got = [losses.sigmoid_focal_loss(*t[:2]),
           losses.sigmoid_focal_loss(*t, gamma=1.5, alpha=0.4),
           losses.dice_loss(*t[:2])]
    for g, w in zip(got, want):
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_bin_codes_match_jax(dtype):
    """encode/decode of bins and headings (half-to-even rounding at the
    wrap included) and the bin-based loss, with and without a mask."""
    rng = np.random.default_rng(6)
    v = rng.uniform(-3.5, 3.5, size=200).astype(dtype)
    ang = np.concatenate([rng.uniform(-np.pi, np.pi, size=200),
                          [np.pi, -np.pi, 0.0]]).astype(dtype)
    logits = rng.normal(size=(200, 12)).astype(dtype)
    res = rng.normal(size=(200, 12)).astype(dtype)
    mask = (rng.uniform(size=200) < 0.5)
    tv, ta = torch.from_numpy(v), torch.from_numpy(ang)
    with _x64(dtype):
        jb, jr = j_losses.encode_bin(jnp.asarray(v), 3.0, 12)
        jdec = j_losses.decode_bin(jb, jr, 3.0, 12)
        hb, hr = j_losses.encode_heading(jnp.asarray(ang), 12)
        hdec = j_losses.decode_heading(hb, hr, 12)
        jl = [j_losses.bin_based_reg_loss(jnp.asarray(logits),
                                          jnp.asarray(res), jnp.asarray(v),
                                          3.0, 12, mask=m)
              for m in (None, jnp.asarray(mask))]
    b, r = losses.encode_bin(tv, 3.0, 12)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    _close(r, jr, dtype)
    _close(losses.decode_bin(b, r, 3.0, 12), jdec, dtype)
    b, r = losses.encode_heading(ta, 12)
    np.testing.assert_array_equal(b.numpy(), np.asarray(hb))
    _close(r, hr, dtype)
    _close(losses.decode_heading(b, r, 12), hdec, dtype)
    for m, w in zip((None, torch.from_numpy(mask)), jl):
        _close(losses.bin_based_reg_loss(torch.from_numpy(logits),
                                         torch.from_numpy(res), tv, 3.0, 12,
                                         mask=m), w, dtype)


# ---------------------------------------------------------------------------
# ops/psroi.py and ops/roipool3d.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("no_trans", [True, False])
def test_psroi_pooling_matches_jax(dtype, no_trans):
    rng = np.random.default_rng(7)
    C_out, G, P, part = 3, 2, 3, 2
    x = rng.normal(size=(1, 20, 24, C_out * G * G)).astype(dtype)
    xy = rng.uniform(0, 30, size=(5, 2))
    rois = np.concatenate([np.zeros((5, 1)), xy,
                           xy + rng.uniform(4, 15, size=(5, 2))],
                          axis=1).astype(dtype)
    offset = rng.normal(size=(5, part * part, 2)).astype(dtype)
    kw = dict(spatial_scale=0.5, pooled_size=P, output_dim=C_out,
              no_trans=no_trans, group_size=G, part_size=part,
              sample_per_part=2, trans_std=0.1)
    with _x64(dtype):
        want = j_psroi(jnp.asarray(x), jnp.asarray(rois),
                       jnp.asarray(offset), **kw)
    got = dcn_v2_psroi_pooling(torch.from_numpy(x), torch.from_numpy(rois),
                               torch.from_numpy(offset), **kw)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_roipool3d_matches_jax(dtype):
    """Membership, enlargement and pooling (member points first in index
    order, zeros after; an empty box flagged), with fewer and more
    members than the sample count."""
    rng = np.random.default_rng(8)
    pts = (rng.uniform(-4, 4, size=(300, 3))
           + np.array([0, 0, 10])).astype(dtype)
    feats = rng.normal(size=(300, 4)).astype(dtype)
    boxes = np.array([[0, 1.65, 10, 1.5, 2.0, 4.0, 0.3],
                      [1.0, 1.0, 9.0, 3.0, 4.0, 5.0, -1.2],
                      [100, 1.65, 10, 1.5, 2.0, 4.0, 0.0]], dtype)
    tp, tf, tb = (torch.from_numpy(a) for a in (pts, feats, boxes))
    with _x64(dtype):
        jp, jf, jb = (jnp.asarray(a) for a in (pts, feats, boxes))
        want_in = j_roi.pts_in_boxes3d(jp, jb)
        want_big = j_roi.enlarge_box3d(jb, 0.4)
        pooled = [j_roi.roipool3d(jp, jf, jb, pool_extra_width=0.5,
                                  sampled_pts_num=s) for s in (16, 64)]
    np.testing.assert_array_equal(roipool3d.pts_in_boxes3d(tp, tb).numpy(),
                                  np.asarray(want_in))
    _close(roipool3d.enlarge_box3d(tb, 0.4), want_big, dtype)
    for s, (wp, we) in zip((16, 64), pooled):
        gp, ge = roipool3d.roipool3d(tp, tf, tb, pool_extra_width=0.5,
                                     sampled_pts_num=s)
        _close(gp, wp, dtype)
        np.testing.assert_array_equal(ge.numpy(), np.asarray(we))


# ---------------------------------------------------------------------------
# utils/drawing.py
# ---------------------------------------------------------------------------

def test_drawing_matches_jax():
    pytest.importorskip("cv2")
    from m3dssd_tpu.utils import drawing as j_drawing
    from m3dssd_tpu_torch.utils import drawing

    p2 = np.array([[700.0, 0, 320, 40], [0, 700.0, 120, 0.5],
                   [0, 0, 1, 0.003]])
    box = (1.0, 1.6, 15.0, 1.7, 1.5, 4.0, 0.4)
    ims = []
    for mod in (drawing, j_drawing):
        im = np.zeros((240, 640, 3), np.uint8)
        mod.draw_2d_box(im, [30.2, 40.7, 100.4, 60.0])
        mod.draw_3d_box(im, p2, *box)
        mod.draw_3d_box(im, p2, 0.0, 1.6, -5.0, 1.7, 1.5, 4.0, 0.0)
        bev = mod.draw_bev((200, 300), np.array([[1.0, 15.0, 1.7, 4.0, 0.4],
                                                 [-5.0, 30.0, 1.6, 3.9,
                                                  -1.0]]))
        ims.append((im, bev))
    np.testing.assert_array_equal(ims[0][0], ims[1][0])
    np.testing.assert_array_equal(ims[0][1], ims[1][1])
    assert ims[0][0].any() and (ims[0][1] != 30).any()

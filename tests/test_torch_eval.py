"""The port's eval chain against the JAX package, on the CPU: bitmask and
plain NMS, the sparse pre-NMS compaction, geometry, hill climbing, the
host post-process and result writer, KITTI parsing, the synthetic data,
and the KITTI AP engine on its Python and native paths.

Inputs are made from numpy seeds; both packages get the same arrays.
"""

import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3dssd_tpu import geometry as j_geo
from m3dssd_tpu.config import kitti_3d_base as j_kitti_3d_base
from m3dssd_tpu.data import kitti as j_kitti
from m3dssd_tpu.data import synthetic as j_synth
from m3dssd_tpu.eval import devkit as j_devkit
from m3dssd_tpu.eval import kitti_eval as j_kitti_eval
from m3dssd_tpu.eval import native as j_native
from m3dssd_tpu.inference import detect as j_detect
from m3dssd_tpu.inference import test_driver as j_driver
from m3dssd_tpu.ops import nms as j_nms
from m3dssd_tpu_torch import geometry as geo
from m3dssd_tpu_torch.config import kitti_3d_base
from m3dssd_tpu_torch.data import kitti
from m3dssd_tpu_torch.data import synthetic
from m3dssd_tpu_torch.eval import devkit
from m3dssd_tpu_torch.eval import kitti_eval
from m3dssd_tpu_torch.eval import native
from m3dssd_tpu_torch.eval import rotate_iou
from m3dssd_tpu_torch.inference import detect
from m3dssd_tpu_torch.inference import hill_climb
from m3dssd_tpu_torch.inference import test_driver as driver
from m3dssd_tpu_torch.ops import nms

# one torch thread per test process: the suite runs several workers at
# once, and torch's default of one thread per core made them
# oversubscribe the machine and slow every worker down
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "golden_ap")
# the JAX package's __init__ files bind these names to functions
j_hill_climb = importlib.import_module("m3dssd_tpu.inference.hill_climb")
j_rotate_iou = importlib.import_module("m3dssd_tpu.eval.rotate_iou")
P2 = synthetic.DEFAULT_P2


# ---------------------------------------------------------------------------
# NMS
# ---------------------------------------------------------------------------

def _boxes(rng, C, ties: bool):
    """[4, C] boxes clustered so that suppression chains form, and [C]
    scores; with `ties`, scores repeat (a handful of distinct values)."""
    cx = rng.uniform(0, 60, C)
    cy = rng.uniform(0, 40, C)
    w = rng.uniform(8, 30, C)
    h = rng.uniform(8, 30, C)
    boxes = np.stack([cx, cy, cx + w, cy + h]).astype(np.float32)
    scores = (rng.integers(0, 6, C) / 6.0 if ties
              else rng.uniform(0, 1, C)).astype(np.float32)
    return boxes, scores


def _chain(C=12):
    """A suppression chain: box k overlaps box k+1 only, scores falling, so
    the greedy keep vector alternates and the fixpoint needs ~C/2 rounds."""
    x = np.arange(C, dtype=np.float32) * 3.0
    boxes = np.stack([x, np.zeros(C), x + 10.0, np.full(C, 10.0)])
    scores = np.linspace(0.9, 0.2, C).astype(np.float32)
    return boxes.astype(np.float32), scores


@pytest.mark.parametrize("case", ["ties", "distinct", "chain", "inf"])
def test_bitmask_nms_matches_jax_and_sequential(case):
    rng = np.random.default_rng(0)
    if case == "chain":
        boxes, scores = _chain()
    else:
        boxes, scores = _boxes(rng, 64, ties=case == "ties")
    if case == "inf":
        scores[rng.choice(64, 20, replace=False)] = -np.inf
    for num_out in (5, 40):
        ji, jv = j_nms.nms_bitmask_select_t(jnp.asarray(boxes),
                                            jnp.asarray(scores), 0.4, num_out)
        ti, tv = nms.nms_bitmask_select_t(torch.from_numpy(boxes),
                                          torch.from_numpy(scores), 0.4,
                                          num_out)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        si, sv = nms.nms_select_t(torch.from_numpy(boxes),
                                  torch.from_numpy(scores), 0.4, num_out)
        np.testing.assert_array_equal(tv.numpy(), sv.numpy())
        np.testing.assert_array_equal(ti[tv].numpy(), si[sv].numpy())
    if case == "chain":
        assert ti[tv].tolist() == list(range(0, 12, 2))


def test_bitmask_nms_batched_images_converge_apart():
    """Images whose fixpoints need different numbers of rounds give, in
    one batch, the indices each gives alone."""
    rng = np.random.default_rng(1)
    chain_b, chain_s = _chain(16)
    rand_b, rand_s = _boxes(rng, 16, ties=True)
    far_b = rand_b + 1000.0 * np.arange(16, dtype=np.float32)  # no overlaps
    boxes = np.stack([chain_b, rand_b, far_b])
    scores = np.stack([chain_s, rand_s, rand_s])
    bi, bv = nms.nms_bitmask_select_t(torch.from_numpy(boxes),
                                      torch.from_numpy(scores), 0.4, 10)
    for b in range(3):
        si, sv = nms.nms_bitmask_select_t(torch.from_numpy(boxes[b]),
                                          torch.from_numpy(scores[b]), 0.4, 10)
        np.testing.assert_array_equal(bi[b].numpy(), si.numpy())
        np.testing.assert_array_equal(bv[b].numpy(), sv.numpy())
    assert bool(bv[2].all())


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
def test_py_cpu_nms_matches_jax(thresh):
    rng = np.random.default_rng(2)
    boxes, scores = _boxes(rng, 120, ties=False)
    dets = np.concatenate([boxes.T, scores[:, None]], axis=1)
    assert nms.py_cpu_nms(dets, thresh) == j_nms.py_cpu_nms(dets, thresh)


def test_sparse_compaction_matches_jax():
    rng = np.random.default_rng(3)
    A, HW = 4, 30
    scores = rng.uniform(0, 0.5, (2, HW * A)).astype(np.float32)
    scores[0, rng.choice(HW * A, 9, replace=False)] = 0.9
    scores[1, rng.choice(HW * A, 3, replace=False)] = 0.9
    for m_pos in (4, 8, 16):
        for b in range(2):
            jc, jok = j_detect._compact_positions(jnp.asarray(scores[b]), A,
                                                  0.75, m_pos)
            tc, tok = detect._compact_positions(
                torch.from_numpy(scores[b:b + 1]), A, 0.75, m_pos)
            np.testing.assert_array_equal(tc[0].numpy(), np.asarray(jc))
            assert bool(tok[0]) == bool(jok)
        ji, jok = j_detect._compact_above(jnp.asarray(scores[0]), 0.75, 8)
        ti, tok = detect._compact_above(torch.from_numpy(scores[0]), 0.75, 8)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert bool(tok) == bool(jok)


def test_sparse_nms_config_matches_jax():
    A = 24
    rois = np.zeros((A * 50, 5))
    anchors = np.zeros((A, 9))
    for over in ({}, {"nms_sparse_topm": 2048}, {"nms_sparse_topm": 64},
                 {"nms_sparse_topm": 2048, "score_thres": 0.0}):
        jconf = j_kitti_3d_base().replace(anchors=anchors, **over)
        conf = kitti_3d_base().replace(anchors=anchors, **over)
        for topk in (False, True):
            assert detect._sparse_nms_cfg(conf, rois, topk) == \
                j_detect._sparse_nms_cfg(jconf, rois, topk)
        assert detect.packed_input_eligible(conf) == \
            j_detect.packed_input_eligible(jconf)


# ---------------------------------------------------------------------------
# geometry, hill climbing, post-process
# ---------------------------------------------------------------------------

def _boxes_3d(rng, n):
    return (rng.uniform(-8, 8, n), rng.uniform(0.5, 1.8, n),
            rng.uniform(6, 50, n), rng.uniform(1.4, 1.8, n),
            rng.uniform(1.3, 1.7, n), rng.uniform(3.2, 4.6, n),
            rng.uniform(-np.pi, np.pi, n))


def test_geometry_matches_jax():
    rng = np.random.default_rng(4)
    x, y, z, w, h, l, ry = _boxes_3d(rng, 16)
    np.testing.assert_array_equal(geo.corners_3d(x, y, z, w, h, l, ry),
                                  j_geo.corners_3d(x, y, z, w, h, l, ry))
    v, c = geo.project_3d(P2, x, y, z, w, h, l, ry, return_3d=True)
    jv, jc = j_geo.project_3d(P2, x, y, z, w, h, l, ry, return_3d=True)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(geo.bbox_from_verts(v),
                                  j_geo.bbox_from_verts(jv))
    p2_inv = np.linalg.inv(P2)
    np.testing.assert_array_equal(geo.backproject(p2_inv, x, y, z),
                                  j_geo.backproject(p2_inv, x, y, z))
    for f in ("convert_alpha_to_rot", "convert_rot_to_alpha"):
        np.testing.assert_array_equal(getattr(geo, f)(ry, z, x),
                                      getattr(j_geo, f)(ry, z, x))
    np.testing.assert_array_equal(geo.snap_to_pi(ry * 5), j_geo.snap_to_pi(ry * 5))
    xywh = np.stack([x, y, w * 10, h * 10], axis=1)
    np.testing.assert_array_equal(geo.xywh_to_xyxy(xywh),
                                  j_geo.xywh_to_xyxy(xywh))


def _dets_table(rng, K=40, n_above=14):
    """A [K, 14] dets table of projectable cars: n_above rows above
    score_thres 0.75, the rest below, in descending score order; 2D boxes
    are the projection of a jittered 3D box, so hill climbing moves."""
    x, y, z, w, h, l, ry = _boxes_3d(rng, K)
    c3d = P2 @ np.stack([x, y, z, np.ones(K)])
    cx, cy = c3d[0] / c3d[2], c3d[1] / c3d[2]
    verts = geo.project_3d(P2, x, y, z, w, h, l, ry)
    box = geo.bbox_from_verts(verts) + rng.normal(0, 2.0, (K, 4))
    alpha = geo.convert_rot_to_alpha(ry, z, x) + rng.normal(0, 0.3, K)
    score = np.concatenate([np.sort(rng.uniform(0.76, 1.0, n_above))[::-1],
                            np.sort(rng.uniform(0.1, 0.74, K - n_above))[::-1]])
    dets = np.stack([box[:, 0], box[:, 1], box[:, 2], box[:, 3], score,
                     rng.integers(1, 4, K).astype(np.float64),
                     cx, cy, z + rng.normal(0, 1.5, K), w, h, l, alpha,
                     rng.integers(0, 24, K).astype(np.float64)], axis=1)
    return dets.astype(np.float32)


def test_hill_climb_matches_jax():
    rng = np.random.default_rng(5)
    dets = _dets_table(rng).astype(np.float64)
    p2_inv = np.linalg.inv(P2)
    args = (P2, p2_inv, dets[:, 0:4], dets[:, 6], dets[:, 7], dets[:, 8],
            dets[:, 9], dets[:, 10], dets[:, 11], dets[:, 12])
    z, ry = hill_climb.hill_climb(*args, step_r_init=0.3 * np.pi, r_lim=0.01)
    jz, jry = j_hill_climb.hill_climb(*args, step_r_init=0.3 * np.pi,
                                      r_lim=0.01)
    np.testing.assert_allclose(z, jz, rtol=0, atol=1e-9)
    np.testing.assert_allclose(ry, jry, rtol=0, atol=1e-9)
    assert np.abs(ry - dets[:, 12]).max() > 0.05       # the climb moved
    ol, inv = hill_climb._objective(*args)
    jol, jinv = j_hill_climb._objective(*args)
    np.testing.assert_allclose(ol, jol, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(inv, jinv)


@pytest.mark.parametrize("hill", [True, False])
def test_postprocess_and_writer_match_jax(hill, tmp_path):
    rng = np.random.default_rng(6)
    dets = _dets_table(rng)
    conf = kitti_3d_base().replace(hill_climbing=hill)
    jconf = j_kitti_3d_base().replace(hill_climbing=hill)
    p2_inv = np.linalg.inv(P2)
    rows = driver.postprocess_dets(conf, dets, P2, p2_inv)
    jrows = j_driver.postprocess_dets(jconf, dets, P2, p2_inv)
    assert len(rows) == len(jrows) == 14
    for r, jr in zip(rows, jrows):
        assert r.keys() == jr.keys() and r["cls"] == jr["cls"]
        for k in r:
            if k != "cls":
                np.testing.assert_allclose(r[k], jr[k], rtol=0, atol=1e-9,
                                           err_msg=k)
    driver.write_kitti_result(str(tmp_path / "port.txt"), rows)
    j_driver.write_kitti_result(str(tmp_path / "jax.txt"), jrows)
    text = (tmp_path / "port.txt").read_bytes()
    assert text == (tmp_path / "jax.txt").read_bytes()
    assert len(text.splitlines()) == 14
    assert all(len(line.split()) == 16 for line in text.splitlines())
    # no row above the threshold: an empty file
    assert driver.postprocess_dets(conf, dets[14:], P2, p2_inv) == []
    driver.write_kitti_result(str(tmp_path / "empty.txt"), [])
    assert (tmp_path / "empty.txt").read_bytes() == b""


# ---------------------------------------------------------------------------
# KITTI parsing and the synthetic data
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A synthetic KITTI-layout dataset written by the JAX generator: a
    validation split only, so it holds SyntheticEvalSet(seed=5)'s scenes."""
    root = str(tmp_path_factory.mktemp("kitti"))
    j_synth.generate(root, num_train=0, num_val=5, seed=5, imW=320, imH=96,
                     min_h_px=8)
    return root


def _val(root, *parts):
    return os.path.join(root, "kitti_split1", "validation", *parts)


def _conf(cls=kitti_3d_base, **over):
    return cls().replace(test_scale=[96, 320], crop_size=[96, 320], **over)


def test_label_and_calib_parsing_match_jax(split):
    p2 = kitti.read_kitti_cal(_val(split, "calib", "000000.txt"))
    np.testing.assert_array_equal(
        p2, j_kitti.read_kitti_cal(_val(split, "calib", "000000.txt")))
    for i in range(5):
        f = _val(split, "label_2", f"{i:06d}.txt")
        for use3d in (False, True):
            got = kitti.read_kitti_label(f, p2, use3d)
            want = j_kitti.read_kitti_label(f, p2, use3d)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.keys() == w.keys()
                for k in g:
                    np.testing.assert_array_equal(np.asarray(g[k]),
                                                  np.asarray(w[k]), err_msg=k)


def test_eval_dataset_matches_jax_and_in_memory_set(split, tmp_path):
    """The port's imdb (PNG header sizes) and samples equal the JAX
    dataset's (cv2 sizes); the in-memory synthetic set gives the same
    samples, and writes the same gt label files."""
    conf = _conf(eval_image_cache_mb=1)
    ds = kitti.Kitti3DDataset(conf, split, phase="validation",
                              cache_folder=str(tmp_path / "cache"))
    jds = j_kitti.Kitti3DDataset(_conf(j_kitti_3d_base), split,
                                 phase="validation")
    mem = synthetic.SyntheticEvalSet(conf, 5, seed=5, imW=320, imH=96,
                                     min_h_px=8)
    assert len(ds) == len(jds) == len(mem) == 5
    for i in range(5):
        assert (ds.imdb[i].imH, ds.imdb[i].imW) == \
            (jds.imdb[i].imH, jds.imdb[i].imW) == (96, 320)
        for s in (ds[i], ds[i], mem[i]):
            want = jds[i]
            np.testing.assert_array_equal(s["input"], want["input"])
            assert s["input"].shape == (96, 320, 3)
            for k in ("p2", "p2_inv", "imH", "imW", "scale_factor", "id"):
                np.testing.assert_array_equal(s["meta"][k], want["meta"][k])
    # the cache held the first image, and the pickled imdb reloads
    assert 0 < ds._cache_bytes and 0 in ds._cache
    again = kitti.build_imdb(conf, split, "validation",
                             cache_folder=str(tmp_path / "cache"))
    assert [o.id for o in again] == [o.id for o in ds.imdb]
    gt = mem.write_labels(str(tmp_path / "gt"))
    for i in range(5):
        name = f"{i:06d}.txt"
        with open(os.path.join(gt, name)) as a, \
                open(_val(split, "label_2", name)) as b:
            assert a.read() == b.read()
    with pytest.raises(ValueError, match="phase"):
        kitti.Kitti3DDataset(conf, split, phase="val_train")


def test_synthetic_scenes_match_jax():
    for seed in (0, 1):
        rows = synthetic.make_scene(np.random.default_rng(seed), 4)
        jrows = j_synth.make_scene(np.random.default_rng(seed), 4)
        assert rows == jrows and rows
        im = synthetic.render_image(rows, rng=np.random.default_rng(seed))
        np.testing.assert_array_equal(
            im, j_synth.render_image(jrows, rng=np.random.default_rng(seed)))
        assert [synthetic._label_line(r) for r in rows] == \
            [j_synth._label_line(r) for r in jrows]
    np.testing.assert_array_equal(synthetic.scaled_p2(0.5),
                                  j_synth.scaled_p2(0.5))
    assert synthetic._calib_text(P2) == j_synth._calib_text(P2)


def test_generate_writes_the_jax_files(tmp_path):
    """The port's KITTI-layout generator writes the JAX generator's files,
    byte for byte (images, calibrations and labels of both splits)."""
    kw = dict(num_train=2, num_val=3, seed=3, imW=320, imH=96, min_h_px=8)
    synthetic.generate(str(tmp_path / "port"), **kw)
    j_synth.generate(str(tmp_path / "jax"), **kw)
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert len(files) == 2 * 3 + 3 * 3
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*")
                           if p.is_file())
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f


# ---------------------------------------------------------------------------
# the KITTI AP engine
# ---------------------------------------------------------------------------

def _engine(use_native, monkeypatch):
    if use_native:
        if not native.available():
            pytest.skip("g++ could not build native/m3deval.cpp")
    else:
        monkeypatch.setattr(native, "available", lambda: False)


# partial/: thresholds [0.9, 0.8] -> precision envelope [1, 2/3, 0, ...]
GOLDEN_CASES = [("perfect", 100.0, 100.0),
                ("partial", 100.0 / 11.0, (2.0 / 3.0) / 40 * 100)]


@pytest.mark.parametrize("use_native", [False, True],
                         ids=["python", "native"])
@pytest.mark.parametrize("case,ap11,r40", GOLDEN_CASES)
def test_golden_ap(case, ap11, r40, use_native, monkeypatch):
    _engine(use_native, monkeypatch)
    res = kitti_eval.evaluate_kitti(os.path.join(GOLDEN, case, "gt"),
                                    os.path.join(GOLDEN, case, "dt"),
                                    classes=["Car"])
    for metric in ["image", "bev", "3d", "aos"]:
        np.testing.assert_allclose(res[f"Car_{metric}"], [ap11] * 3,
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(res[f"Car_{metric}_R40"], [r40] * 3,
                                   rtol=0, atol=1e-9)


@pytest.fixture(scope="module")
def scene_set(tmp_path_factory):
    """gt of 12 synthetic scenes (cars, pedestrians, cyclists) and
    detections made from them: jittered boxes with scores, some dropped,
    some false positives."""
    root = tmp_path_factory.mktemp("ap")
    conf = kitti_3d_base().replace(test_scale=[375, 1242])
    mem = synthetic.SyntheticEvalSet(
        conf, 12, seed=9, classes=("Car", "Pedestrian", "Cyclist"),
        max_objs=6)
    gt = mem.write_labels(str(root / "gt"))
    dt = root / "dt"
    dt.mkdir()
    rng = np.random.default_rng(10)
    for i in range(len(mem)):
        lines = []
        for r in mem.labels(i):
            if rng.uniform() < 0.15:
                continue
            j = dict(r)
            for k in ("x1", "y1", "x2", "y2"):
                j[k] += rng.normal(0, 3.0)
            for k in ("x", "z"):
                j[k] += rng.normal(0, 0.4)
            j["ry"] += rng.normal(0, 0.2)
            j["alpha"] += rng.normal(0, 0.2)
            lines.append(synthetic._label_line(j)
                         + f" {rng.uniform(0.3, 1.0):.4f}")
        for _ in range(rng.integers(0, 3)):
            x1, y1 = rng.uniform(0, 1100), rng.uniform(100, 300)
            lines.append(f"Car 0.00 0 0.1 {x1:.2f} {y1:.2f} {x1 + 60:.2f} "
                         f"{y1 + 45:.2f} 1.5 1.6 3.9 {rng.uniform(-9, 9):.2f} "
                         f"1.65 {rng.uniform(8, 40):.2f} 0.2 "
                         f"{rng.uniform(0.1, 0.9):.4f}")
        (dt / f"{i:06d}.txt").write_text("\n".join(lines) + "\n")
    return gt, str(dt)


@pytest.mark.parametrize("use_native", [False, True],
                         ids=["python", "native"])
def test_ap_matches_jax_engine(scene_set, use_native, monkeypatch):
    _engine(use_native, monkeypatch)
    if not use_native:
        monkeypatch.setattr(j_native, "available", lambda: False)
    gt, dt = scene_set
    classes = ["Car", "Pedestrian", "Cyclist"]
    res = kitti_eval.evaluate_kitti(gt, dt, classes=classes)
    want = j_kitti_eval.evaluate_kitti(gt, dt, classes=classes)
    assert res.keys() == want.keys() and "Car_3d_R40" in res
    for k, v in res.items():
        if k == "_text":
            assert v == want[k]
        else:
            np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-9,
                                       err_msg=k)
    assert 0.0 < res["Car_3d_R40"][1] < 100.0


# kitti_eval's metric name -> the devkit oracle's
DEVKIT_METRIC = {"image": "image", "bev": "ground", "3d": "box3d",
                 "aos": "aos"}


@pytest.mark.parametrize("case", ["perfect", "partial", "scenes"])
def test_devkit_oracle_matches_engine_and_jax(case, scene_set):
    """The port's devkit oracle prints what the JAX package's does, and the
    AP engine agrees with it within 1e-6 on every metric both report."""
    if not devkit.available():
        pytest.skip("g++ could not build native/devkit_eval.cpp")
    if case == "scenes":
        (gt, dt), classes = scene_set, ["Car", "Pedestrian", "Cyclist"]
    else:
        gt, dt = (os.path.join(GOLDEN, case, d) for d in ("gt", "dt"))
        classes = ["Car"]
    oracle = devkit.evaluate(gt, dt)
    assert oracle == j_devkit.evaluate(gt, dt)
    ours = kitti_eval.evaluate_kitti(gt, dt, classes=classes)
    compared = 0
    for cname in classes:
        for metric, dk in DEVKIT_METRIC.items():
            for suffix in ("", "_R40"):
                key = f"{cname}_{dk}{suffix}"
                if key in oracle:
                    np.testing.assert_allclose(
                        ours[f"{cname}_{metric}{suffix}"], oracle[key],
                        rtol=0, atol=1e-6, err_msg=key)
                    compared += 1
    assert compared >= 8 * (len(classes) if case == "scenes" else 1)


def test_overlaps_and_statistics_match_jax():
    """Rotated and 3D overlaps, and the matching of both engines, against
    the JAX package's Python engine."""
    rng = np.random.default_rng(11)
    n, k = 20, 15

    def boxes(m):
        return np.stack([rng.uniform(-10, 10, m), rng.uniform(0, 2, m),
                         rng.uniform(5, 40, m), rng.uniform(3, 5, m),
                         rng.uniform(1, 2, m), rng.uniform(1, 2, m),
                         rng.uniform(-np.pi, np.pi, m)], axis=1)
    a, b = boxes(n), boxes(k)
    b[:5] = a[:5]
    want = j_rotate_iou.d3_box_overlap(a, b)
    np.testing.assert_allclose(rotate_iou.d3_box_overlap(a, b), want,
                               rtol=0, atol=1e-12)
    bev = a[:, [0, 2, 3, 5, 6]], b[:, [0, 2, 3, 5, 6]]
    np.testing.assert_allclose(rotate_iou.rotate_iou(*bev),
                               j_rotate_iou.rotate_iou(*bev), rtol=0,
                               atol=1e-12)
    if native.available():
        np.testing.assert_allclose(native.d3_box_overlap(a, b), want,
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(native.rotated_iou(*bev),
                                   j_rotate_iou.rotate_iou(*bev),
                                   rtol=1e-9, atol=1e-9)
    dt = np.concatenate([rng.uniform(0, 300, (n, 4)), rng.uniform(-3, 3, (n, 1)),
                         rng.uniform(0, 1, (n, 1))], axis=1)
    gtd = np.concatenate([rng.uniform(0, 300, (k, 4)),
                          rng.uniform(-3, 3, (k, 1))], axis=1)
    ig = rng.integers(-1, 2, k)
    idt = rng.integers(-1, 2, n)
    for fp in (False, True):
        args = (want, gtd, dt, ig, idt, np.zeros((0, 4)), 2, 0.3)
        ref = j_kitti_eval.compute_statistics(*args, thresh=0.4,
                                              compute_fp=fp, compute_aos=fp)
        fns = [kitti_eval.compute_statistics,
               kitti_eval.compute_statistics_fast]
        if native.available():
            fns.append(native.compute_statistics)
        for fn in fns:
            got = fn(*args, thresh=0.4, compute_fp=fp, compute_aos=fp)
            assert got[:3] == ref[:3]
            np.testing.assert_allclose(got[3], ref[3], rtol=0, atol=1e-9)
            np.testing.assert_allclose(got[4], ref[4], rtol=0, atol=0)

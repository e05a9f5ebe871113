"""The port's run directory: the four CLIs end to end on the CPU over a
synthetic KITTI split on disk (train -> test from the source snapshot ->
export -> eval_trajectory), seed checkpoints, partial weight loading and
the source snapshot (the cases of tests/test_source_snapshot.py).
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from m3dssd_tpu_torch.anchors import locate_anchors
from m3dssd_tpu_torch.config import (Config, flagship_conf,
                                     kitti_3d_anab_fullalign)
from m3dssd_tpu_torch.data.synthetic import generate
from m3dssd_tpu_torch.eval.kitti_eval import evaluate_kitti
from m3dssd_tpu_torch.inference.detect import make_detector
from m3dssd_tpu_torch.inference.export import load_detector
from m3dssd_tpu_torch.models import build
from m3dssd_tpu_torch.scripts import eval_trajectory as traj_cli
from m3dssd_tpu_torch.scripts import export_model as export_cli
from m3dssd_tpu_torch.scripts import test as test_cli
from m3dssd_tpu_torch.scripts import train as train_cli
from m3dssd_tpu_torch.train.trainer import Trainer
from m3dssd_tpu_torch.utils.checkpoint import (is_seed_checkpoint,
                                               load_model_weights,
                                               load_pretrained_params,
                                               restore_seed, save_seed)
from m3dssd_tpu_torch.utils.source_snapshot import (snapshot_path,
                                                    snapshot_source)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_reference_layout import reference_state_dict  # noqa: E402

# one torch thread per test process (see tests/test_torch_train.py)
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "m3dssd_tpu_torch")
CROP = ["64", "224"]
TRAIN_ARGS = ["--config", "kitti_3d_anab_fullalign", "--epochs", "1",
              "--batch_size", "2", "--backbone", "dla34", "--crop", *CROP,
              "--no_pretrain"]


def _cli(name, *args, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", f"m3dssd_tpu_torch.scripts.{name}", *args],
        capture_output=True, text=True, env=env, cwd=cwd, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_cli")
    generate(str(root / "data"), num_train=4, num_val=2, seed=3, imW=224,
             imH=64, min_h_px=6)
    return root


@pytest.fixture(scope="module")
def run(kitti):
    """A run directory trained by the train CLI (1 epoch, 2 steps)."""
    out = _cli("train", *TRAIN_ARGS, "--data_root", "data", "--output",
               "out", "--cache", "cache", "--cpu", cwd=str(kitti))
    assert "(2 steps)" in out
    return kitti, str(kitti / "out")


def test_train_cli_run_directory(run):
    _, out = run
    assert sorted(os.listdir(out)) == ["conf.pkl", "log", "model_src",
                                       "seed", "weights"]
    assert os.listdir(os.path.join(out, "weights")) == ["step_2"]
    assert is_seed_checkpoint(out)
    conf = Config.load(os.path.join(out, "conf.pkl"))
    assert conf.back_bone == "dla34" and list(conf.crop_size) == [64, 224]
    assert snapshot_path(out) == os.path.join(out, "model_src")


def test_test_cli_runs_the_snapshot(run):
    """The test CLI prefers the run's snapshot and prints the AP table;
    its detections equal those of the live package."""
    root, out = run
    text = _cli("test", "--run_dir", out, "--data_root", "data", "--cpu",
                cwd=str(root))
    src = os.path.join(out, "model_src", "m3dssd_tpu_torch")
    assert f"m3dssd_tpu_torch source: {src}" in text
    assert "Car AP" in text and "selection metric" in text
    snap = os.path.join(out, "results", "results_test_2", "data")
    shutil.copytree(snap, snap + "_snapshot")
    text = _cli("test", "--run_dir", out, "--data_root", "data", "--cpu",
                "--no_src_snapshot", cwd=str(root))
    assert f"m3dssd_tpu_torch source: {PKG}" in text
    names = sorted(os.listdir(snap))
    assert names == sorted(os.listdir(snap + "_snapshot")) and names
    for n in names:
        with open(os.path.join(snap, n)) as a, \
                open(os.path.join(snap + "_snapshot", n)) as b:
            assert a.read() == b.read(), n


def test_test_cli_with_torch_weights(run):
    """`--torch_weights`: the run's weights written as a checkpoint of the
    original model go through the upstream import (conf pinned to the
    gather DCN) into results_parity_<tag>."""
    root, out = run
    conf = Config.load(os.path.join(out, "conf.pkl"))
    model = build(conf, device="cpu")
    load_model_weights(model, os.path.join(out, "weights"))
    pth = os.path.join(str(root), "reference.pth")
    torch.save(reference_state_dict(model, conf.anchors.shape[0],
                                    conf.num_classes), pth)
    text = _cli("test", "--run_dir", out, "--data_root", "data", "--cpu",
                "--torch_weights", pth, cwd=str(root))
    assert "selection metric" in text
    res = os.path.join(out, "results", "results_parity_reference", "data")
    assert sorted(os.listdir(res)) == ["000000.txt", "000001.txt"]


def test_export_cli_and_load(run):
    """Single-image export of the run's checkpoint with BN folded: the
    loaded artifact gives eager detect's dets."""
    root, out = run
    art = os.path.join(out, "det.pt2")
    text = _cli("export_model", "--run_dir", out, "--out", art, "--fold_bn",
                "--cpu", cwd=str(root))
    assert "wrote" in text
    det = load_detector(art, device="cpu")
    assert det.meta["batch_size"] == 0 and det.meta["platforms"] == ["cpu"]
    conf = Config.load(os.path.join(out, "conf.pkl"))
    model = build(conf, device="cpu")
    load_model_weights(model, os.path.join(out, "weights"))
    rois = locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    img = np.random.default_rng(0).normal(
        size=(1, 64, 224, 3)).astype(np.float32)
    want = make_detector(conf, rois, model, device="cpu")(img, 1.0)
    got = det(img, np.float32(1.0))
    assert got.shape == want.shape == (conf.nms_topN_post, 14)
    valid = want[:, 4] > 0
    assert torch.equal(got[:, 4] > 0, valid)
    assert torch.equal(got[valid, 5], want[valid, 5])
    assert float((got - want).abs().max()) <= 1e-4 * max(
        float(want.abs().max()), 1.0)


def test_eval_trajectory_cli(run):
    root, out = run
    res = os.path.join(out, "results")
    src = os.path.join(res, "results_test_2", "data")
    if not os.path.isdir(src):
        _cli("test", "--run_dir", out, "--data_root", "data", "--cpu",
             cwd=str(root))
    for epoch in (1, 3):
        shutil.copytree(src, os.path.join(res, f"results_{epoch}", "data"),
                        dirs_exist_ok=True)
    gt = os.path.join(str(root), "data", "kitti_split1", "validation",
                      "label_2")
    text = _cli("eval_trajectory", "--run", out, "--gt", gt, "--cpu",
                cwd=str(root))
    last = text.strip().splitlines()[-1]
    assert last.startswith("TRAJECTORY ")
    rows = json.loads(last[len("TRAJECTORY "):])
    assert [r["epoch"] for r in rows] == [1, 3]
    want = evaluate_kitti(gt, src)
    for k in ("Car_image_R40", "Car_bev_R40", "Car_3d_R40"):
        assert rows[0][k] == [round(v, 2) for v in want[k]]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_clis_raise_without_a_card_unless_asked_for_the_cpu(run):
    root, out = run
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(TRAIN_ARGS + ["--data_root", str(root / "data"),
                                     "--output", str(root / "nocard")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        test_cli.main(["--run_dir", out, "--data_root", str(root / "data"),
                       "--no_src_snapshot"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_cli.main(["--run_dir", out, "--out", str(root / "x.pt2")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        traj_cli.main(["--run", out, "--gt", str(root)])
    with pytest.raises(ValueError, match="mesh_devices"):
        test_cli.main(["--run_dir", out, "--data_root", "x", "--cpu",
                       "--mesh_spatial", "2"])
    with pytest.raises(RuntimeError, match="torchrun"):
        test_cli.main(["--run_dir", out, "--data_root", "x", "--cpu",
                       "--mesh_devices", "2"])


# ---------------------------------------------------------------------------
# seeds and partial loading
# ---------------------------------------------------------------------------

def _tiny_conf(**kw):
    return kitti_3d_anab_fullalign().replace(
        crop_size=[64, 224], test_scale=[64, 224], num_anchor_scales=2,
        back_bone="dla34", compute_dtype="float32", pre_train=False,
        batch_size=2, num_workers=2, eval_batch_size=2, display_iter=2,
        do_test=False, **kw)


def test_seed_starts_a_run_with_a_fresh_optimizer(kitti, tmp_path):
    conf = _tiny_conf(max_epoch=1)
    data = str(kitti / "data")
    tr = Trainer(conf, data, str(tmp_path / "a"), device="cpu")
    tr.run(1)
    assert tr.state.step == 2 and tr.state.optimizer.count == 2
    seed_dir = str(tmp_path / "seeded")
    save_seed(seed_dir, tr.model)
    payload = torch.load(os.path.join(seed_dir, "seed", "seed.pt"),
                         weights_only=True)
    assert sorted(payload) == ["model"]

    fresh = build(conf, device="cpu", seed=9, phase="train")
    restore_seed(seed_dir, fresh)
    a, b = tr.model.state_dict(), fresh.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)

    tr2 = Trainer(conf.replace(pretrained=seed_dir), data,
                  str(tmp_path / "b"), device="cpu")
    b = tr2.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert tr2.state.step == 0 and tr2.state.optimizer.count == 0
    assert tr2.state.optimizer.state == {}


def test_load_pretrained_params_partial():
    conf = flagship_conf((64, 128), num_scales=2, backbone="dla34",
                         dtype="float32")
    dst = build(conf, device="cpu", seed=0).state_dict()
    src = build(conf, device="cpu", seed=1).state_dict()
    src = {k: v.double() for k, v in src.items()}
    src.pop("cls_tower.Conv_2.weight")
    src["bbox_x.Conv_2.weight"] = torch.zeros(3, 3)
    src["extra.weight"] = torch.zeros(2)
    out, report = load_pretrained_params(dst, src)
    assert sorted(report["unmatched"]) == ["bbox_x.Conv_2.weight",
                                           "cls_tower.Conv_2.weight"]
    assert report["loaded"] == len(dst) - 2
    for k, v in out.items():
        assert v.dtype == dst[k].dtype
        want = dst[k] if k in report["unmatched"] else src[k].to(v.dtype)
        assert torch.equal(v, want), k
    out, report = load_pretrained_params(dst, src, filter_prefixes=["base."])
    assert 0 < report["loaded"] < len(dst) - 2
    assert all(torch.equal(out[k], dst[k]) for k in out
               if not k.startswith("base."))


# ---------------------------------------------------------------------------
# the source snapshot
# ---------------------------------------------------------------------------

def _run_py(code, cwd, **env):
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(cwd), timeout=300,
                         env=dict(os.environ, **env))
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def test_snapshot_copies_package(tmp_path):
    """Python and CUDA sources copied verbatim; build outputs and caches
    left out."""
    run = str(tmp_path / "run")
    os.makedirs(run)
    root = snapshot_source(run)
    assert root == os.path.join(run, "model_src")
    assert snapshot_path(run) == root
    for rel in ("__init__.py", "models/rpn.py", "ops/dcn.py",
                "ops/dcn_op.py", "ops/nms_op.py", "config.py",
                "csrc/dcn_shift.cu", "csrc/dcn_shift_bwd.cu",
                "csrc/dcn_shift_common.cuh", "csrc/nms.cu"):
        with open(os.path.join(root, "m3dssd_tpu_torch", rel), "rb") as a, \
                open(os.path.join(PKG, rel), "rb") as b:
            assert a.read() == b.read(), rel
    for dirpath, dirnames, files in os.walk(root):
        assert "__pycache__" not in dirnames and "_build" not in dirnames
        assert not any(f.endswith((".pyc", ".so", ".o")) for f in files)
    assert snapshot_path(str(tmp_path)) is None


def test_snapshot_import_wins_over_live_package(tmp_path):
    """Importing through the snapshot resolves to the snapshot's code,
    whose kernel build goes to its own _build/."""
    run = str(tmp_path / "run")
    os.makedirs(run)
    root = snapshot_source(run)
    with open(os.path.join(root, "m3dssd_tpu_torch", "__init__.py"),
              "a") as f:
        f.write("\n__snapshot_marker__ = 'training-time-code'\n")
    pkg = os.path.join(root, "m3dssd_tpu_torch")
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import m3dssd_tpu_torch\n"
        "assert m3dssd_tpu_torch.__file__.startswith(%r)\n"
        "assert m3dssd_tpu_torch.__snapshot_marker__ == 'training-time-code'\n"
        "from m3dssd_tpu_torch.ops import _build, dcn_op\n"
        "assert _build.BUILD_DIR == %r, _build.BUILD_DIR\n"
        "print('snapshot import ok')\n" % (root, root,
                                           os.path.join(pkg, "_build")))
    assert "snapshot import ok" in _run_py(code, tmp_path)


def test_snapshot_import_keeps_native_eval(tmp_path):
    """From the snapshot, the native AP engine's sources are found through
    M3DSSD_NATIVE_DIR (the test CLI sets it)."""
    native_dir = os.path.join(ROOT, "native")
    run = str(tmp_path / "run")
    os.makedirs(run)
    root = snapshot_source(run)
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from m3dssd_tpu_torch.eval import native\n"
        "assert native.__file__.startswith(%r), native.__file__\n"
        "assert native.NATIVE_DIR == %r, native.NATIVE_DIR\n"
        "print('native dir ok')\n" % (root, root, native_dir))
    assert "native dir ok" in _run_py(code, tmp_path,
                                      M3DSSD_NATIVE_DIR=native_dir)

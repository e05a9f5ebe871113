"""The port's quality and serving CLIs run on the CPU at 64x224 with
DLA-34: learn_probe, convergence_check (in memory, and on disk with host
targets and a batch pool) and eval_fallback_bench, each in a fresh process
started together with a time limit (so the native engine switch and the
training stay in those processes), and serve_check's function in this
process with iters=1.
"""

import json
import math
import os
import shutil
import subprocess
import sys

import pytest
import torch

from m3dssd_tpu_torch.config import flagship_conf
from m3dssd_tpu_torch.scripts import serve_check as sc

# one torch thread per test process (see tests/test_torch_train.py)
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300
SMALL = ["--batch_size", "2", "--crop", "64", "224", "--cpu"]
RUNS = {
    "learn_probe": ["learn_probe", "--in_memory", "--images", "2",
                    "--steps", "2", "--log_every", "1", "--aug_pool", "1",
                    "--variants", "run2,run2aug,plain", *SMALL],
    "convergence_in_memory": ["convergence_check", "--in_memory",
                              "--num_train", "4", "--num_val", "2",
                              "--epochs", "2", "--eval_epoch", "1", *SMALL],
    "convergence_on_disk": ["convergence_check", "--num_train", "4",
                            "--num_val", "2", "--epochs", "1",
                            "--eval_epoch", "1", "--host_targets",
                            "--pool", "2", *SMALL],
    "eval_fallback_bench": ["eval_fallback_bench", "12"],
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every CLI of RUNS started at once, each in its own root directory;
    yields {name: (process, root)}, then stops any still running and
    removes the roots (the runs' checkpoints take some 1.3 GB)."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = {}
    try:
        for name, (mod, *args) in RUNS.items():
            root = tmp_path_factory.mktemp(name)
            extra = [] if mod == "eval_fallback_bench" else ["--root",
                                                             str(root)]
            procs[name] = (subprocess.Popen(
                [sys.executable, "-m", f"m3dssd_tpu_torch.scripts.{mod}",
                 *args, *extra], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, env=env, cwd=str(root)),
                root)
        yield procs
    finally:
        for p, root in procs.values():
            if p.poll() is None:
                p.kill()
            p.communicate()
            shutil.rmtree(root, ignore_errors=True)


def _output(runs, name):
    p, root = runs[name]
    out, err = p.communicate(timeout=TIMEOUT)
    assert p.returncode == 0, err[-4000:]
    return out, root


def test_serve_check_in_process(runs):
    """Export, reload and the live detector agree on the CPU (float32,
    the single-image signature). `runs` starts the CLIs' processes first,
    so they go on beside this test."""
    conf = flagship_conf((64, 224), num_scales=2, backbone="dla34",
                         dtype="float32")
    lines = []
    res = sc.run_serve_check(conf, batch_size=0, iters=1, device="cpu",
                             log=lines.append)
    assert res["serve_check"] == "ok", res
    assert res["max_abs_diff"] < sc.TOL
    assert res["latency_ms"] > 0 and res["eager_ms"] > 0
    assert res["artifact_mb"] > 1
    assert any("served latency" in s for s in lines)
    assert any("eager latency" in s for s in lines)


def test_learn_probe_runs(runs):
    out, _ = _output(runs, "learn_probe")
    for name in ("run2", "run2aug", "plain"):
        assert f"[{name}] step 1 loss=" in out
        assert f"[{name}] step 2 loss=" in out
        line = [s for s in out.splitlines()
                if s.startswith(f"RESULT {name}: ")]
        assert len(line) == 1, out
        verdict = line[0].split()[2]
        assert verdict in ("LEARNS", "COLLAPSED")
        acc = float(line[0].split("acc_fg=")[1].split()[0])
        assert (verdict == "LEARNS") == (acc > 0.5)
        assert math.isfinite(float(line[0].split("loss=")[1].split()[0]))
    assert "built 1 fixed batches" in out
    assert "built 1 augmented batches" in out


def _report(out):
    lines = [s for s in out.splitlines()
             if s.startswith("CONVERGENCE_REPORT ")]
    assert len(lines) == 1 and out.splitlines()[-1] == lines[0]
    rep = json.loads(lines[0][len("CONVERGENCE_REPORT "):])
    assert sorted(rep) == ["train_car_3d_r40", "train_car_bbox_r40",
                           "val_best", "val_trajectory"]
    return rep


def test_convergence_check_in_memory(runs):
    """Two epochs with an eval after each; the train-split eval reads the
    training scenes' labels; nothing is written under <root>/data."""
    out, root = _output(runs, "convergence_in_memory")
    rep = _report(out)
    assert [t["epoch"] for t in rep["val_trajectory"]] == [1, 2]
    vals = [t["val_car_3d_r40"] for t in rep["val_trajectory"]]
    assert all(math.isfinite(v) and 0 <= v <= 100 for v in vals)
    assert rep["val_best"] == max(vals)
    assert math.isfinite(rep["train_car_3d_r40"])
    assert len(rep["train_car_bbox_r40"]) == 3
    assert not os.path.exists(root / "data")
    run = root / "out"
    assert sorted(os.listdir(run / "results" / "train_split" / "gt")) == \
        [f"{i:06d}.txt" for i in range(4)]
    assert sorted(os.listdir(run / "results" / "train_split" / "data")) == \
        [f"{i:06d}.txt" for i in range(4)]
    assert sorted(os.listdir(run / "weights")) == ["step_2", "step_4"]


def test_convergence_check_on_disk(runs):
    """The split written under <root>/data and read back, host targets and
    a pool of 2 batches cycled in place of the loader."""
    out, root = _output(runs, "convergence_on_disk")
    rep = _report(out)
    assert "generated synthetic KITTI: 4 train / 2 val" in out
    assert "device pool: 2 batches" in out
    assert [t["epoch"] for t in rep["val_trajectory"]] == [1]
    assert math.isfinite(rep["train_car_3d_r40"])
    assert len(rep["train_car_bbox_r40"]) == 3
    split = root / "data" / "kitti_split1"
    assert len(os.listdir(split / "training" / "image_2")) == 4
    assert sorted(os.listdir(root / "out" / "results" / "train_split" /
                             "data")) == [f"{i:06d}.txt" for i in range(4)]


def test_eval_fallback_bench_runs(runs):
    out, _ = _output(runs, "eval_fallback_bench")
    line = out.strip().splitlines()[-1]
    assert line.startswith("python fallback over 12 images x 3 classes x "
                           "AOS: fused ")
    assert line.endswith("AP tables equal")

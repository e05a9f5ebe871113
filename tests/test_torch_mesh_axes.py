"""The port's spatial and model mesh axes (`m3dssd_tpu_torch/parallel/`)
on the CPU: gloo ranks in fresh processes (tests/torch_parallel_runner.py,
case "axes", one launch per layout) against one process, and the layout
and the sharded leaves against the JAX package's mesh.

The reference's GSPMD step over a (data, spatial, model) mesh is the
single-device step on the global batch (tests/test_loss_train.py); so must
the port's be. Tolerances, as tests/test_torch_parallel.py's: a float64
step within F64_TOL (1e-9; the loss computes in float32 on a float64
model, so its stats within LOSS_TOL_F64, 1e-6), a float32 step within
F32_MESH_TOL (below), and the collectives bit for bit in every float
type. Detect under the
spatial axis against unsharded detect at tests/test_e2e.py's rtol 1e-4,
atol 1e-3, with the same kept boxes; dla34_depth's DLASeg in float64
within 1e-9 of the largest value. Each rank of a model axis holds
1/mp of exactly the leaves JAX's rule shards (min_model_dim 32 at these
widths) and of their momentum, and a checkpoint round-trips between mp = 2
and mp = 1.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from m3dssd_tpu.parallel import make_mesh as j_make_mesh
from m3dssd_tpu.parallel import replicate_state as j_replicate_state
from m3dssd_tpu_torch.anchors import locate_anchors
from m3dssd_tpu_torch.inference.detect import make_batch_detector
from m3dssd_tpu_torch.models import build
from m3dssd_tpu_torch.parallel import model_axis
from m3dssd_tpu_torch.parallel.mesh import axis_groups, mesh_coords
from m3dssd_tpu_torch.train.state import create_train_state, make_train_step
from m3dssd_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                               save_checkpoint)
from m3dssd_tpu_torch.utils.weights import from_flax_variables

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_parallel import (DP_STEP_TOL, F64_TOL, LOSS_TOL_F64,  # noqa
                                 ROOT, RUNNER, STEP_CROP, _batch, _eval_conf,
                                 _port_conf,
                                 _rel, _step_conf, _t, _update_errors)
import torch_parallel_runner as runner  # noqa: E402

torch.set_num_threads(1)

# (data, spatial, model) of each launch
LAYOUTS = {"spatial": (1, 2, 1), "model": (1, 1, 2), "both": (1, 2, 2)}
DET_TOL = dict(rtol=1e-4, atol=1e-3)
# The float32 step on the mesh against one process (_f32_errors). The
# data axis alone meets DP_STEP_TOL because each image's forward and
# backward run as on one process, bit for bit; only the ranks' gradient
# sum rounds otherwise. A slab's halo-extended 3x3 conv and the channel
# slices' upsampling ConvTranspose round otherwise from the first such
# layer (read 5.8e-7 and 2.0e-6 of its output), which grows through the
# train-mode BN layers to ~1e-4 (spatial) and ~1e-5 (model) at the head
# and to some 1e-3 to 1e-2 of the gradients at these tiny shapes: the
# size of the one-process float32 gradient's own error against float64
# (median 8.4e-3, largest 1.05e-2). Read on the mesh: gradients median
# 5.6e-3 / 1.0e-3 (spatial / model), largest 6.7e-3 / 1.2e-3; stats
# 5.6e-6; BN statistics 1.19e-5 (one process against float64 1.29e-5).
# Parameters are held in float32 ulps beyond the gradients' move: an
# update is ~1e-5 of its parameter here, so the parameter's ulp is ~1e-2
# of the update; two roundings (lr g and p - lr g) bound it by 2 (read:
# 0.99995). What the collectives carry is held bit for bit
# (test_collectives_move_values_exactly), which these limits could not
# resolve.
F32_MESH_TOL = {"stats": 1e-5, "grad_median": 1e-2, "grad_largest": 1.5e-2,
                "bn_stats": 3e-5, "param_ulps": 2.0}
# dla34_depth's DLASeg in float64 (in float32 its rounding reaches 9e-3
# of the input's gradient through the 125 M-parameter chain; float64
# read 3e-14)
DEPTH_TOL = 1e-9
DEPTH_IM = (512, 32)


def _detect_conf():
    return dict(_eval_conf(), crop=STEP_CROP)


def _start(work, world):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, RUNNER, "axes", str(r),
                              str(world), str(work)], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True) for r in range(world)]


def _finish(work, procs, timeout=600):
    for p in procs:
        out, _ = p.communicate(timeout=timeout)
        assert p.returncode == 0, out[-4000:]
    return [torch.load(os.path.join(work, f"axes.rank{r}.pt"),
                       weights_only=False) for r in range(len(procs))]


def _checkpoint(conf, path, dtype, momentum=True):
    """A one-process checkpoint of the seed-0 train build, with a seeded
    momentum buffer for every parameter or none (the step's buffers are
    then its gradients)."""
    model = build(conf, device="cpu", phase="train").to(dtype)
    state = create_train_state(conf, model, max_iter=100)
    gen = torch.Generator().manual_seed(7)
    for n, p in model.named_parameters():
        if momentum:
            state.optimizer.state[n] = {"momentum_buffer": 1e-3 * torch.randn(
                p.shape, generator=gen, dtype=torch.float64).to(dtype)}
    save_checkpoint(path, state, 0)
    return {k: v.clone() for k, v in model.state_dict().items()}


def _single_step(conf, ckpt, batch, dtype):
    model = build(conf, device="cpu", phase="train").to(dtype)
    state = create_train_state(conf, model, max_iter=100)
    restore_checkpoint(ckpt, state)
    rois = locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    lr = state.optimizer.lr()
    stats = make_train_step(conf, rois)(state, {
        k: v.to(dtype) if v.is_floating_point() else v
        for k, v in batch.items()})
    return {"stats": {k: float(v) for k, v in stats.items()},
            "state": {k: v.clone() for k, v in model.state_dict().items()},
            "momentum": {n: st["momentum_buffer"].clone()
                         for n, st in state.optimizer.state.items()},
            "model": model, "lr": lr}


@pytest.fixture(scope="module")
def axes(tmp_path_factory):
    """The three launches and, while they run, the one-process references:
    both steps, detect and dla34_depth's DLASeg."""
    work = tmp_path_factory.mktemp("axes")
    conf = _port_conf(_step_conf())
    rois = locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    before = {torch.float64: _checkpoint(conf, str(work / "ckpt64"),
                                         torch.float64),
              torch.float32: _checkpoint(conf, str(work / "ckpt32"),
                                         torch.float32, momentum=False)}
    batch = _t(_batch(rois.shape[0], B=2))
    econf = _port_conf(_detect_conf())
    rng = np.random.default_rng(2)
    images = torch.from_numpy(rng.normal(
        size=(2,) + tuple(econf.crop_size) + (3,)).astype(np.float32))
    sfs = torch.ones(2)
    depth = torch.from_numpy(rng.normal(size=(1,) + DEPTH_IM + (3,)))
    procs = {}
    try:
        for name, (d, s, m) in LAYOUTS.items():
            w = work / name
            w.mkdir()
            inputs = {"axes": {
                "spatial": s, "model": m, "conf": _step_conf(),
                "ckpt64": str(work / "ckpt64"),
                "ckpt32": str(work / "ckpt32"), "batch": batch,
                "detect": {"conf": _detect_conf(), "images": images,
                           "sfs": sfs}}}
            if name == "spatial":
                inputs["axes"]["depth"] = depth
            torch.save(inputs, w / "inputs.pt")
            procs[name] = (w, _start(w, d * s * m))
        ref = {"conf": conf, "before": before, "rois": rois}
        for dtype, key in ((torch.float64, "f64"), (torch.float32, "f32")):
            ref[key] = _single_step(conf, str(work / f"ckpt{key[1:]}"),
                                    batch, dtype)
        model = build(econf, device="cpu", seed=3)
        erois = locate_anchors(econf.anchors, econf.feat_size,
                               econf.feat_stride)
        ref["detect"] = make_batch_detector(econf, erois, model,
                                            device="cpu")(images, sfs)
        ref["depth"] = runner.depth_run(runner.depth_seg(), depth)
        out = {name: _finish(w, ps) for name, (w, ps) in procs.items()}
    finally:
        for _, ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    return ref, out, work


# ---------------------------------------------------------------------------
# the layout (pure functions)
# ---------------------------------------------------------------------------

def test_rank_layout_and_groups_match_jax_mesh():
    """Rank r of a 2 x 2 x 2 mesh sits where JAX's make_mesh(8, spatial=2,
    model=2) puts device r, and each group holds the ranks that differ
    only in its axes."""
    jm = j_make_mesh(8, spatial=2, model=2)
    assert jm.axis_names == ("data", "spatial", "model")
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for r in range(8):
        assert ids[mesh_coords(r, 2, 2)] == r
    g = axis_groups(8, 2, 2)
    assert g["model"] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert g["spatial"] == [[0, 2], [1, 3], [4, 6], [5, 7]]
    assert g["data"] == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert g["batch"] == [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert g["mesh"] == [list(range(8))]
    for axis, lists in (("model", g["model"]), ("spatial", g["spatial"]),
                        ("data", g["data"])):
        k = jm.axis_names.index(axis)
        for ranks in lists:
            want = ids[tuple(slice(None) if i == k else
                             mesh_coords(ranks[0], 2, 2)[i]
                             for i in range(3))]
            assert sorted(want.tolist()) == ranks, axis


def test_model_sharded_leaves_equal_jax_rule():
    """The leaves the port shards on its model axis are those JAX's
    replicate_state(min_model_dim=32) shards over 'model' on the same
    (flagship, tiny) tree, compared through utils/weights.py's names."""
    import __graft_entry__
    from m3dssd_tpu.models import build as j_build

    jconf = __graft_entry__._flagship_conf((64, 128), num_scales=2,
                                           backbone="dla34",
                                           dtype="float32")
    # the rule reads shapes only: the tree's shapes, as zeros
    shapes = jax.eval_shape(
        lambda: j_build(jconf).init(jax.random.PRNGKey(0),
                                    np.zeros((1, 64, 128, 3), np.float32),
                                    train=False))
    tree = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                  {k: shapes[k] for k in ("params",
                                                          "batch_stats")})
    placed = j_replicate_state(j_make_mesh(2, model=2), tree,
                               min_model_dim=32)
    flags = jax.tree_util.tree_map(
        lambda x: np.full(x.shape, float("model" in str(x.sharding.spec)),
                          np.float32), placed)
    sd = from_flax_variables(flags)
    want = {k for k, v in sd.items() if v.dim() and bool(v.all())}
    assert want
    conf = _port_conf(_step_conf())
    got = set(model_axis.shard_specs(build(conf, device="cpu"), 2, 32))
    assert got == want


# ---------------------------------------------------------------------------
# the launches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_coordinates(axes, layout):
    _, out, _ = axes
    d, s, m = LAYOUTS[layout]
    for r, o in enumerate(out[layout]):
        assert o["coords"] == mesh_coords(r, s, m)
        assert o["extents"] == (d, s, m)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_float64_step_equals_one_process(axes, layout):
    """A float64 train step on the mesh equals the one-process step on the
    global batch (F64_TOL), momentum included; every rank gathers the same
    whole state."""
    ref, out, _ = axes
    want = ref["f64"]
    got = [o["f64"] for o in out[layout]]
    names = list(want["momentum"])
    for g in got:
        assert g["spatial"] == (LAYOUTS[layout][1] > 1)
        for k, v in want["stats"].items():
            np.testing.assert_allclose(g["stats"][k], v, rtol=LOSS_TOL_F64,
                                       atol=1e-12, err_msg=k)
        median, largest = _update_errors(g["state"], want["state"],
                                         ref["before"][torch.float64],
                                         names)
        assert median <= F64_TOL and largest <= F64_TOL, (median, largest)
        for n, v in want["state"].items():
            if n.endswith(("running_mean", "running_var")):
                assert _rel(g["state"][n], v) <= F64_TOL, n
        for n, v in want["momentum"].items():
            assert _rel(g["momentum"][n], v) <= F64_TOL, n
    for g in got[1:]:
        assert all(torch.equal(g["state"][k], got[0]["state"][k])
                   for k in got[0]["state"])


def _f32_errors(got, want):
    """A float32 step against another: the stats' largest relative error;
    the gradients' (the new momentum buffers, from none) median over
    tensors of each tensor's error against its own largest value and the
    largest error against the largest gradient (`_update_errors`); the
    BN statistics' largest relative error; and the parameters' largest
    error in float32 ulps of the parameter, beyond what the gradients'
    difference moves them by (lr |dg|)."""
    names = list(want["momentum"])
    zeros = {n: torch.zeros_like(v) for n, v in want["momentum"].items()}
    median, largest = _update_errors(got["momentum"], want["momentum"], zeros,
                                     names)
    ulps = 0.0
    for n in names:
        a, b = got["state"][n].double(), want["state"][n].double()
        top = torch.maximum(a.abs(), b.abs()).float()
        ulp = (torch.nextafter(top, torch.full_like(top, float("inf")))
               - top).double()
        moved = want["lr"] * (got["momentum"][n].double()
                              - want["momentum"][n].double()).abs()
        ulps = max(ulps, float(((a - b).abs() - moved).clamp(min=0).div(
            ulp).max()))
    return {"stats": max(abs(got["stats"][k] - v) / max(abs(v), 1e-7)
                         for k, v in want["stats"].items()),
            "grad_median": median, "grad_largest": largest,
            "bn_stats": max(_rel(got["state"][n], v)
                            for n, v in want["state"].items()
                            if n.endswith(("running_mean", "running_var"))),
            "param_ulps": ulps}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_float32_step_within_one_process_rounding(axes, layout):
    """A float32 step on the mesh against the one-process step, within
    F32_MESH_TOL: the stats, the gradients (the step's momentum buffers),
    the BN statistics, and each parameter within two float32 ulps of the
    one process's beyond what the gradients' difference moves it by."""
    ref, out, _ = axes
    e = _f32_errors(out[layout][0]["f32"], ref["f32"])
    for k, lim in F32_MESH_TOL.items():
        assert e[k] <= lim, (k, e[k], lim)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_detect_on_mesh_matches_unsharded(axes, layout):
    """Detect of a model built on the mesh against unsharded detect
    (tests/test_e2e.py:331's tolerance), with the same kept boxes."""
    ref, out, _ = axes
    want = ref["detect"]
    for o in out[layout]:
        got = o["detect"]
        assert int((want[..., 4] >= 0).sum()) > 0
        np.testing.assert_array_equal(got[..., 4] >= 0, want[..., 4] >= 0)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **DET_TOL)


@pytest.mark.parametrize("layout", ["model", "both"])
def test_each_model_rank_holds_its_slice_of_jax_leaves(axes, layout):
    """Each rank holds 1/mp of exactly the sharded leaves (the JAX rule's
    set, test_model_sharded_leaves_equal_jax_rule) and of their momentum;
    the rest whole."""
    ref, out, _ = axes
    conf = ref["conf"]
    specs = set(model_axis.shard_specs(build(conf, device="cpu"), 2, 32))
    full = {n: tuple(p.shape) for n, p in ref["f64"]["model"]
            .named_parameters()}
    for o in out[layout]:
        g = o["f64"]
        assert set(g["sharded"]) == specs
        for n, shape in full.items():
            part = g["shapes"][n]
            if n in specs:
                assert np.prod(part) * 2 == np.prod(shape), n
            else:
                assert part == shape, n
            assert g["mom_shapes"][n] == part, n


def test_checkpoint_round_trips_between_model_extents(axes):
    """The mp = 2 ranks restored the one-process checkpoint (sliced on
    load) and wrote theirs whole; it restores at mp = 1 into exactly the
    state they gathered."""
    ref, out, work = axes
    conf = ref["conf"]
    model = build(conf, device="cpu", phase="train").double()
    state = create_train_state(conf, model, max_iter=100)
    restore_checkpoint(str(work / "model" / "saved"), state)
    got = out["model"][0]["f64"]
    assert state.step == 1
    sd = model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in got["state"].items())
    assert all(torch.equal(state.optimizer.state[n]["momentum_buffer"], v)
               for n, v in got["momentum"].items())


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_collectives_pass_gradcheck(axes, layout):
    """The halo exchange (halos within a neighbour and past it), both row
    gathers and the channel gather."""
    _, out, _ = axes
    for o in out[layout]:
        assert o["gradcheck"] and all(o["gradcheck"].values()), \
            o["gradcheck"]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_collectives_move_values_exactly(axes, layout):
    """The halo exchange, the row gather, the channel gather and copy_to
    move values bit for bit in float64, float32, bf16 (sent as float16
    words) and float16, forward and backward (integer-valued tensors,
    whose sums are exact): no collective rounds what it carries."""
    _, out, _ = axes
    d, s, m = LAYOUTS[layout]
    kinds = (["halo", "rows"] if s > 1 else []) + (
        ["channels", "copy_to"] if m > 1 else [])
    want = {f"{k}_{t}" for k in kinds
            for t in ("float64", "float32", "bfloat16", "float16")}
    for o in out[layout]:
        assert set(o["exact"]) == want
        assert all(o["exact"].values()), o["exact"]


def test_dla34_depth_seg_under_spatial_axis(axes):
    """dla34_depth's DLASeg (row-banded LocalConv2d, picked by global row)
    in train mode, float64, at 512 x 32 on the 2 spatial ranks of data
    coordinate
    0 (BatchNorm over them): the output and
    the input's gradient as one process's, and each parameter's gradient
    by its norm and two random projections (against the gradient's whole
    norm)."""
    ref, out, _ = axes
    want = ref["depth"]
    total = float(sum(v[0] ** 2 for v in want["params"].values())) ** 0.5
    for o in out["spatial"][:2]:
        got = o["depth"]
        assert got["active"]
        assert _rel(got["y"], want["y"]) <= DEPTH_TOL
        assert _rel(got["dimages"], want["dimages"]) <= DEPTH_TOL
        worst = max(float((got["params"][k] - v).abs().max())
                    for k, v in want["params"].items()) / total
        assert worst <= DEPTH_TOL, worst


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def test_train_and_test_clis_on_model_and_spatial_axes(tmp_path, capsys):
    """The train CLI with --mesh_model 2 and the test CLI with
    --mesh_devices 2 --mesh_spatial 2 under `python -m
    torch.distributed.run --standalone --nproc_per_node 2` on the CPU: the
    checkpoint holds whole tensors (it loads into a one-process model), the
    AP table prints once; then the eval watcher over the run's checkpoint
    (--max_polls 1)."""
    from m3dssd_tpu_torch.data.synthetic import generate
    from m3dssd_tpu_torch.scripts import test as test_cli
    from m3dssd_tpu_torch.scripts import watch_eval
    from m3dssd_tpu_torch.utils.checkpoint import load_model_weights

    root = str(tmp_path / "data")
    generate(root, num_train=4, num_val=2, seed=3, imW=128, imH=64,
             min_h_px=6)
    run = str(tmp_path / "run")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    launch = [sys.executable, "-m", "torch.distributed.run", "--standalone",
              "--nproc_per_node", "2", "-m"]
    res = subprocess.run(
        launch + ["m3dssd_tpu_torch.scripts.train", "--distributed",
                  "--mesh_model", "2", "--cpu", "--config",
                  "kitti_3d_anab_fullalign", "--data_root", root, "--output",
                  run, "--cache", str(tmp_path / "cache"), "--epochs", "1",
                  "--batch_size", "2", "--backbone", "dla34", "--crop", "64",
                  "128", "--no_pretrain"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.count("run directory:") == 2
    conf = test_cli.load_conf(run)
    assert (conf.mesh_model, conf.mesh_spatial) == (2, 1)
    step = load_model_weights(build(conf, device="cpu"),
                              os.path.join(run, "weights"))
    res = subprocess.run(
        launch + ["m3dssd_tpu_torch.scripts.test", "--mesh_devices", "2",
                  "--mesh_spatial", "2", "--cpu", "--run_dir", run,
                  "--data_root", root],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.count("selection metric") == 1
    data = os.path.join(run, "results", f"results_test_{step}", "data")
    assert len(os.listdir(data)) == 2
    capsys.readouterr()
    watch_eval.main(["--run_dir", run, "--data_root", root, "--max_polls",
                     "1", "--poll_sec", "0", "--cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and lines[0].startswith(
        f"step {step}: mean Car 3D R40 = ")
    watched = os.path.join(run, "results", f"results_watch_{step}", "data")
    assert sorted(os.listdir(watched)) == sorted(os.listdir(data))
    for f in os.listdir(data):
        assert open(os.path.join(watched, f)).read() == \
            open(os.path.join(data, f)).read()


def test_setup_split_links_renumbered_ids(tmp_path):
    from m3dssd_tpu_torch.scripts import setup_split

    kitti = tmp_path / "kitti"
    for sub, ext in (("calib", ".txt"), ("image_2", ".png"),
                     ("label_2", ".txt")):
        (kitti / "training" / sub).mkdir(parents=True)
        for i in ("000003", "000007", "000010"):
            (kitti / "training" / sub / f"{i}{ext}").write_text(sub + i)
    (tmp_path / "train.txt").write_text("000007\n000003\n\n")
    (tmp_path / "val.txt").write_text("000010\n")
    setup_split.main(["--kitti", str(kitti), "--out", str(tmp_path / "out"),
                      "--train_ids", str(tmp_path / "train.txt"),
                      "--val_ids", str(tmp_path / "val.txt")])
    base = tmp_path / "out" / "kitti_split1"
    assert (base / "training" / "image_2" / "000000.png").read_text() == \
        "image_2000007"
    assert (base / "training" / "label_2" / "000001.txt").read_text() == \
        "label_2000003"
    assert (base / "validation" / "calib" / "000000.txt").read_text() == \
        "calib000010"
    assert os.path.islink(base / "validation" / "calib" / "000000.txt")


@pytest.mark.parametrize("batch,dp,sp,mp,world,want", [
    (8, -1, 2, 1, 4, 2), (8, -1, 2, 2, 8, 2), (6, -1, 1, 2, 8, 3),
    (4, -1, 2, 2, 4, 1), (8, 2, 2, 1, 8, 2)])
def test_data_parallel_size_fits_spatial_and_model_axes(batch, dp, sp, mp,
                                                        world, want):
    """The data axis is the largest divisor of the batch that fits the
    world's ranks over spatial x model (m3dssd_tpu/train/trainer.py's
    sizing), or conf.dp_devices."""
    from m3dssd_tpu_torch.config import flagship_conf
    from m3dssd_tpu_torch.train.trainer import data_parallel_size

    conf = flagship_conf((64, 128)).replace(batch_size=batch, dp_devices=dp,
                                            mesh_spatial=sp, mesh_model=mp)
    assert data_parallel_size(conf, world) == want

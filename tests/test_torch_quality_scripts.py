"""The port's quality and serving CLIs (learn_probe, convergence_check,
serve_check, eval_fallback_bench) against the JAX package's scripts,
without training: the configurations each builds, learn_probe's fixed
batches, the fallback bench's annotations and AP tables, the in-memory
split, and the refusal to run without a card.

The JAX scripts run with their trainer or train state stubbed out; every
stub, `sys.argv` and `sys.path` are put back by monkeypatch, and the global
numpy rng that the JAX dataset draws from is restored. Runs of the CLIs
are in tests/test_torch_quality_runs.py.
"""

import dataclasses
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from m3dssd_tpu_torch.data.kitti import Kitti3DDataset
from m3dssd_tpu_torch.scripts import convergence_check as cc
from m3dssd_tpu_torch.scripts import eval_fallback_bench as efb
from m3dssd_tpu_torch.scripts import learn_probe as lp
from m3dssd_tpu_torch.scripts import serve_check as sc

# one torch thread per test process (see tests/test_torch_train.py)
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP = (64, 224)
IMG_ABS = 5e-4              # the port's warp vs OpenCV, after /std
VARIANT_NAMES = list(lp.VARIANTS)


class Stop(Exception):
    pass


def _jax_script(name, mp):
    """The JAX package's `scripts/<name>.py` as a fresh module (not put in
    sys.modules); the sys.path entry it adds is undone with `mp`."""
    mp.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_same_conf(got, want, skip=()):
    """Every field of the JAX `want` equal in the port's `got`; the split's
    anchors and whitening stats to float64 rounding."""
    names = {f.name for f in dataclasses.fields(got)}
    assert names == {f.name for f in dataclasses.fields(want)}
    for name in sorted(names - set(skip)):
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-9, atol=1e-12, err_msg=name)
        else:
            assert a == b, (name, a, b)


# --------------------------------------------------------------- the confs

CONV_ARGV = {
    "defaults": [],
    "lr_bs8": ["--lr", "0.008", "--batch_size", "8"],
    "anab_fullalign": ["--config", "kitti_3d_anab_fullalign",
                       "--host_targets", "--grad_clip", "0"],
}


@pytest.mark.parametrize("argv", list(CONV_ARGV.values()),
                         ids=list(CONV_ARGV))
def test_convergence_conf_matches_jax(argv, tmp_path, monkeypatch):
    """The JAX script's main up to its Trainer, which a stub replaces: the
    conf it would train equals the port CLI's for the same flags."""
    import m3dssd_tpu.train.trainer as jtrainer

    mod = _jax_script("convergence_check", monkeypatch)
    # a split directory already there: the JAX script generates nothing
    os.makedirs(tmp_path / "data" / "kitti_split1")
    seen = {}

    def stub(conf, *args, **kw):
        seen["conf"] = conf
        raise Stop

    monkeypatch.setattr(jtrainer, "Trainer", stub)
    monkeypatch.setattr(sys, "argv", ["convergence_check.py", "--root",
                                      str(tmp_path), *argv])
    with pytest.raises(Stop):
        mod.main()
    conf = cc.conf_from_args(cc.parse_args(argv))
    _assert_same_conf(conf, seen["conf"])
    assert conf.compute_dtype == "bfloat16" and conf.stem_s2d \
        and conf.dcn_shift_clamp is not None


def test_convergence_conf_refuses_slow_paths(monkeypatch):
    """A configuration with a fast path off is refused, as the JAX script
    asserts."""
    from m3dssd_tpu_torch import config

    monkeypatch.setitem(config.CONFIGS, "slow", lambda **kw:
                        config.kitti_3d_base(compute_dtype="float32"))
    with pytest.raises(ValueError, match="fast paths"):
        cc.make_conf("slow")


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    """learn_probe's JAX main over a 64x224 synthetic split on disk, all six
    variants, with `create_train_state` and `make_train_step` stubbed: the
    confs it would train, the rois, and the batches it collates."""
    import m3dssd_tpu.data.loader as jloader
    import m3dssd_tpu.train.state as jstate

    root = tmp_path_factory.mktemp("probe")
    data_root = str(root / "data")
    cc.generate_split(data_root, 6, 2, CROP)
    confs, rois, collated = [], [], []
    real_collate = jloader.collate

    def create_train_state(conf, model, rng, steps):
        confs.append(conf)
        return "state"

    def make_train_step(conf, r, packed_input=False):
        rois.append((np.asarray(r), packed_input))
        stats = dict.fromkeys(("loss", "loss_cls", "acc_fg", "acc_bg",
                               "iou", "err_z"), 0.0)
        return lambda state, batch, key: (state, stats)

    def collate(samples):
        batch = real_collate(samples)
        collated.append(batch)
        return batch

    np_state = np.random.get_state()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mod = _jax_script("learn_probe", mp)
            mp.setattr(jstate, "create_train_state", create_train_state)
            mp.setattr(jstate, "make_train_step", make_train_step)
            mp.setattr(jloader, "collate", collate)
            # the script's compilation-cache settings are those
            # tests/conftest.py has already made
            mp.setattr(sys, "argv", [
                "learn_probe.py", "--root", str(root), "--steps", "1",
                "--images", "4", "--batch_size", "2", "--crop",
                *map(str, CROP), "--aug_pool", "1", "--variants",
                ",".join(VARIANT_NAMES)])
            mod.main()
    finally:
        np.random.set_state(np_state)
    return {"root": root, "data_root": data_root, "confs": confs,
            "rois": rois, "collated": collated, "VARIANTS": mod.VARIANTS}


@pytest.fixture(scope="module")
def port_probe(probe, tmp_path_factory):
    """The port's probe data over the same split: (base conf, dataset cut
    to 4 images, fixed batches)."""
    conf = lp.make_conf(batch_size=2, crop=CROP)
    ds = Kitti3DDataset(lp.no_aug(conf), probe["data_root"], phase="train",
                        cache_folder=str(tmp_path_factory.mktemp("cache")))
    return lp.probe_data(conf, ds, 4)


def test_learn_probe_variants_match_jax(probe):
    assert lp.VARIANTS == probe["VARIANTS"]


@pytest.mark.parametrize("i", range(len(VARIANT_NAMES)), ids=VARIANT_NAMES)
def test_learn_probe_conf_matches_jax(probe, port_probe, i):
    """Each variant's conf as the JAX script builds it, but for two
    settings: the JAX script prints acc_fg and err_z, which its default
    `loss_light_stats` leaves out of the stats, so the port keeps them; and
    the port clips the gradient as the convergence run does (the JAX
    script's run2 claims the convergence run's semantics but has no
    clip)."""
    from m3dssd_tpu.losses.rpn_loss import RPNLossConfig

    base, _, _ = port_probe
    jconf = probe["confs"][i]
    conf = lp.variant_conf(base, VARIANT_NAMES[i])
    _assert_same_conf(conf, jconf,
                      skip=("loss_light_stats", "grad_clip_norm"))
    assert RPNLossConfig.from_conf(jconf).light_stats
    assert not conf.loss_light_stats
    assert jconf.grad_clip_norm is None
    assert conf.grad_clip_norm == cc.make_conf().grad_clip_norm == 5.0
    assert probe["rois"][i][1] == bool(conf.stem_s2d)


def test_learn_probe_fixed_batches_match_jax(probe, port_probe):
    """The identity batches over the split's first 4 images: the same
    images (to the warp's rounding), targets and rois as JAX's; packed as
    JAX packs them."""
    from m3dssd_tpu.models.dla import space_to_depth_np

    _, ds, fixed = port_probe
    want = probe["collated"][:len(fixed)]
    assert len(fixed) == 2
    np.testing.assert_allclose(ds.rois, probe["rois"][0][0], rtol=1e-12,
                               atol=1e-9)
    for got, w in zip(fixed, want):
        assert sorted(got) == sorted(w)
        for k, wv in w.items():
            g, wv = np.asarray(got[k]), np.asarray(wv)
            assert g.shape == wv.shape and g.dtype == wv.dtype, k
            if k == "images":
                assert np.abs(g - wv).max() <= IMG_ABS
            elif np.issubdtype(wv.dtype, np.floating):
                np.testing.assert_allclose(g, wv, rtol=1e-6, atol=1e-6,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(g, wv, err_msg=k)
        packed = lp.to_device(got, True, "cpu")["images"].numpy()
        assert np.abs(packed - space_to_depth_np(w["images"])).max() \
            <= IMG_ABS
    assert sum(int(b["labels_fg"].sum()) for b in fixed) > 0


def test_learn_probe_pool_is_augmented(port_probe):
    """run2aug's pool comes from the loader with the base conf's
    augmentation on, over the same images."""
    from m3dssd_tpu_torch.data.augment import Augmentation

    base, ds, _ = port_probe
    assert base.mirror_prob > 0 and base.trans_prob > 0
    assert isinstance(ds.transform, Augmentation)
    assert len(ds.imdb) == 4


# ------------------------------------------------------- in-memory split

def test_in_memory_split_is_the_written_split(tmp_path):
    """--in_memory holds the scenes the on-disk split gets: the train-split
    eval set has the training split's labels, the val set the validation
    split's, and the train set the training split's images."""
    cv2 = pytest.importorskip("cv2")
    conf = cc.make_conf(batch_size=2, crop=CROP)
    train = cc.in_memory_train_set(conf, 5)
    val, train_eval = cc.in_memory_eval_sets(conf, 5, 3)
    assert (len(train), len(train_eval), len(val)) == (5, 5, 3)
    data_root = str(tmp_path / "data")
    assert cc.generate_split(data_root, 5, 3, CROP)
    assert not cc.generate_split(data_root, 5, 3, CROP)    # already there
    split = os.path.join(data_root, "kitti_split1")
    for ds, sub in ((train_eval, "training"), (val, "validation")):
        written = ds.write_labels(str(tmp_path / f"gt_{sub}"))
        disk = os.path.join(split, sub, "label_2")
        assert sorted(os.listdir(written)) == sorted(os.listdir(disk))
        for name in os.listdir(disk):
            with open(os.path.join(written, name)) as a, \
                    open(os.path.join(disk, name)) as b:
                assert a.read() == b.read(), (sub, name)
        for i in range(len(ds)):
            im = cv2.imread(os.path.join(split, sub, "image_2",
                                         f"{i:06d}.png"))
            np.testing.assert_array_equal(ds.scenes[i][1], im)
    for i in range(5):
        np.testing.assert_array_equal(train.images[i],
                                      train_eval.scenes[i][1])
        assert [g.cls for g in train.imdb[i].gts] == \
            [r["cls"] for r in train_eval.labels(i)]


# --------------------------------------------------- eval_fallback_bench

@pytest.mark.parametrize("seed", [0, 7])
def test_synth_annos_match_jax(seed, monkeypatch):
    jb = _jax_script("eval_fallback_bench", monkeypatch)
    for got, want in zip(efb.synth_annos(6, seed), jb.synth_annos(6, seed)):
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_fused_and_per_threshold_ap_tables_equal(monkeypatch):
    """The bench's two forms give the same AP tables on the Python engine
    (native.available stubbed off; the environment is untouched), and the
    per-threshold form is put back after."""
    from m3dssd_tpu_torch.eval import kitti_eval as ke
    from m3dssd_tpu_torch.eval import native

    monkeypatch.setattr(native, "available", lambda: False)
    orig = ke.fused_statistics_py
    fused_s, loop_s, a, b = efb.run_eval_fallback_bench(8, seed=3)
    assert ke.fused_statistics_py is orig
    assert fused_s > 0 and loop_s > 0
    assert sorted(a) == ["orientation", "precision", "recall"]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert np.nanmax(a["precision"]) > 0.5


def test_fallback_bench_refuses_the_native_engine(monkeypatch):
    from m3dssd_tpu_torch.eval import native

    monkeypatch.setattr(native, "available", lambda: True)
    with pytest.raises(RuntimeError, match="M3DSSD_NO_NATIVE"):
        efb.run_eval_fallback_bench(2)


# --------------------------------------------------------- the card CLIs

@pytest.mark.parametrize("mod,argv", [
    (lp, ["--in_memory"]), (cc, ["--in_memory"]), (cc, []), (sc, []),
    (sc, ["--flagship"])], ids=["learn_probe", "convergence_in_memory",
                                "convergence_on_disk", "serve_check",
                                "serve_check_flagship"])
def test_card_cli_raises_without_a_card(mod, argv, tmp_path, monkeypatch):
    """Without --cpu each card CLI raises before it builds or writes
    anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = ["--root", str(tmp_path / "root")] if mod is not sc else []
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(root + argv)
    assert os.listdir(tmp_path) == []

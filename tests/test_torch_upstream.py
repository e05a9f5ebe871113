"""Checkpoints of the original PyTorch model in the port, against the JAX
package's import (`utils/torch_import.py`).

A reference-layout state dict is synthesized from the tiny flagship's JAX
tree with the JAX `flax_to_torch_key` (as tests/test_torch_import.py does),
imported into JAX and into the port; the port's state dict must equal
`from_flax_variables` of the JAX import exactly, with the same counts. Then
`pin_parity_conf`, the Trainer's import of a .pth in conf.pretrained, and
a forward under the pinned conf (the neck on the unbounded gather DCN)
against JAX.
"""

import os
import sys

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

import __graft_entry__
from m3dssd_tpu.models import build as j_build
from m3dssd_tpu.utils.torch_import import flax_to_torch_key as j_key
from m3dssd_tpu.utils.torch_import import \
    load_reference_checkpoint as j_load_reference_checkpoint
from m3dssd_tpu.utils.torch_import import pin_parity_conf as j_pin
from m3dssd_tpu_torch.config import Config, flagship_conf
from m3dssd_tpu_torch.data.synthetic import SyntheticTrainSet
from m3dssd_tpu_torch.models import build
from m3dssd_tpu_torch.models.necks import DCN
from m3dssd_tpu_torch.train.trainer import Trainer
from m3dssd_tpu_torch.utils.torch_import import (has_learned_dcn_offsets,
                                                 load_reference_checkpoint,
                                                 load_torch_file,
                                                 pin_parity_conf)
from m3dssd_tpu_torch.utils.weights import from_flax_variables

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_reference_layout import reference_state_dict  # noqa: E402

# one torch thread per test process (see tests/test_torch_train.py)
torch.set_num_threads(1)

CROP = (64, 128)
# float32 through a deep chain of convolutions summed in another order
DEEP = dict(rtol=1e-3, atol=1e-3)


def _confs(**kw):
    jconf = __graft_entry__._flagship_conf(
        CROP, num_scales=2, backbone="dla34", dtype="float32").replace(**kw)
    conf = flagship_conf(CROP, num_scales=2, backbone="dla34",
                         dtype="float32").replace(**kw)
    return jconf, conf


def _torch_shape(leaf, flax_shape):
    if leaf in ("kernel", "weight") and len(flax_shape) == 4:
        kh, kw, i, o = flax_shape
        return (o, i, kh, kw)
    return tuple(flax_shape)


def _reference_sd(variables, A, C, seed, sane=False):
    """A state dict in the original model's names and layouts, one tensor
    per JAX leaf. `sane`: values a forward can run on (weights scaled by
    fan-in, positive BN variances, learned neck offsets up to a few
    pixels); else plain normals."""
    rng = np.random.default_rng(seed)
    sd = {}
    for coll in ("params", "batch_stats"):
        for path, val in jtu.tree_flatten_with_path(variables[coll])[0]:
            parts = tuple(str(k.key) for k in path)
            key, _ = j_key(parts[:-1], parts[-1], num_anchors=A,
                           num_classes=C)
            shape = _torch_shape(parts[-1], np.asarray(val).shape)
            t = rng.normal(size=shape)
            if sane:
                if key.endswith("running_var"):
                    t = rng.uniform(0.5, 1.5, size=shape)
                elif len(shape) == 4:
                    scale = 2.0 if "conv_offset_mask" in key else 1.0
                    t = t * scale / np.sqrt(np.prod(shape[1:]))
                elif key.endswith("weight") and len(shape) == 1:
                    t = rng.uniform(0.8, 1.2, size=shape)
                else:
                    t = t * 0.1
            sd[key] = t.astype(np.float32)
    return sd


@pytest.fixture(scope="module")
def tree():
    jconf, conf = _confs()
    jmodel = j_build(jconf)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1,) + CROP + (3,)), train=False)
    variables = jtu.tree_map(np.asarray, dict(variables))
    return jconf, conf, variables


def _jax_import(variables, sd, A, C):
    params, stats_tree, stats = j_load_reference_checkpoint(
        variables, sd, num_anchors=A, num_classes=C, block="basic")
    return {"params": params, "batch_stats": stats_tree}, stats


@pytest.mark.parametrize("drop", [0, 7], ids=["full", "partial"])
def test_import_equals_from_flax_variables(tree, drop):
    """Every tensor bit-equal to the JAX import's through
    from_flax_variables, with the same loaded, unmapped and missing
    counts; `partial` leaves 7 keys out and adds a stray one."""
    jconf, conf, variables = tree
    A, C = jconf.anchors.shape[0], jconf.num_classes
    sd = _reference_sd(variables, A, C, seed=0)
    for k in sorted(sd)[::max(len(sd) // drop, 1)][:drop] if drop else []:
        del sd[k]
    if drop:
        sd["module.not_a_layer.weight"] = np.zeros(3, np.float32)
    jvars, jstats = _jax_import(variables, sd, A, C)
    want = from_flax_variables(jvars)

    # start from JAX's initial values, which a key left out keeps
    model = build(conf, device="cpu")
    model.load_state_dict(from_flax_variables(variables), strict=True)
    got, stats = load_reference_checkpoint(model, sd, num_anchors=A,
                                           num_classes=C, block="basic")
    assert stats["loaded"] == jstats["loaded"]
    assert len(stats["unmapped"]) == len(jstats["unmapped"])
    assert sorted(stats["missing"]) == sorted(jstats["missing"])
    assert len(stats["missing"]) == drop
    assert not stats["shape_mismatch"] and not jstats["shape_mismatch"]
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    model.load_state_dict(got, strict=True)


def test_reference_state_dict_inverts_the_import(tree):
    """The port's weights written back in the original names and layouts
    give the synthesized state dict exactly, and import back bit-equal."""
    jconf, conf, variables = tree
    A, C = jconf.anchors.shape[0], jconf.num_classes
    sd = _reference_sd(variables, A, C, seed=4)
    model = build(conf, device="cpu")
    got, _ = load_reference_checkpoint(model, sd, num_anchors=A,
                                       num_classes=C)
    model.load_state_dict(got, strict=True)
    ref = reference_state_dict(model, A, C)
    assert ref.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(ref[k], torch.from_numpy(v)), k
    again, stats = load_reference_checkpoint(model, ref, num_anchors=A,
                                             num_classes=C)
    assert stats["loaded"] == len(sd) and not stats["missing"]
    assert all(torch.equal(again[k], got[k]) for k in got)


def test_pin_parity_conf():
    _, conf = _confs()
    jconf, _ = _confs()
    offsets = {"base.dla_up.ida_0.proj_1.conv.conv_offset_mask.weight":
               np.zeros((27, 8, 3, 3), np.float32)}
    trunk = {"base.base.base_layer.0.weight":
             np.zeros((16, 3, 7, 7), np.float32)}
    assert has_learned_dcn_offsets(offsets)
    assert not has_learned_dcn_offsets(trunk)
    for sd in (offsets, trunk):
        assert pin_parity_conf(conf, sd).dcn_shift_clamp == \
            j_pin(jconf, sd).dcn_shift_clamp
    assert pin_parity_conf(conf, offsets).dcn_shift_clamp is None
    assert pin_parity_conf(conf, trunk).dcn_shift_clamp == 1.0
    pinned = conf.replace(dcn_shift_clamp=None)
    assert pin_parity_conf(pinned, offsets).dcn_shift_clamp is None


def test_trainer_imports_a_torch_file(tree, tmp_path):
    """A .pth in conf.pretrained: the Trainer pins the conf before the
    build (and saves the pinned conf with the run), and its model holds
    the imported weights."""
    jconf, conf, variables = tree
    A, C = jconf.anchors.shape[0], jconf.num_classes
    sd = _reference_sd(variables, A, C, seed=1, sane=True)
    pth = str(tmp_path / "reference.pth")
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(v)
                               for k, v in sd.items()}}, pth)
    loaded = load_torch_file(pth)
    assert all(torch.equal(loaded[f"module.{k}"], torch.from_numpy(v))
               for k, v in sd.items())

    tconf = conf.replace(anchors=None, bbox_means=None, bbox_stds=None,
                         batch_size=2, num_workers=1, pretrained=pth)
    ds = SyntheticTrainSet(tconf, 4, seed=3, imW=224, imH=64, min_h_px=6)
    tr = Trainer(tconf, None, str(tmp_path / "run"), device="cpu",
                 dataset=ds)
    assert tr.conf.dcn_shift_clamp is None
    assert Config.load(str(tmp_path / "run" / "conf.pkl")).dcn_shift_clamp \
        is None
    assert not any(m.uses_shift for m in tr.model.modules()
                   if isinstance(m, DCN))
    want, stats = load_reference_checkpoint(
        build(tr.conf, device="cpu", phase="train"), loaded,
        num_anchors=A, num_classes=C)
    assert stats["loaded"] > 100
    got = tr.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_pinned_forward_matches_jax(tree):
    """Weights with learned neck offsets of a few pixels, imported into
    both frameworks under the pinned conf: the whole model's outputs."""
    jconf, conf, variables = tree
    A, C = jconf.anchors.shape[0], jconf.num_classes
    sd = _reference_sd(variables, A, C, seed=2, sane=True)
    jconf, conf = j_pin(jconf, sd), pin_parity_conf(conf, sd)
    assert jconf.dcn_shift_clamp is None and conf.dcn_shift_clamp is None
    jmodel = j_build(jconf)
    jvars, _ = _jax_import(jtu.tree_map(np.asarray, dict(jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + CROP + (3,)),
        train=False))), sd, A, C)
    model = build(conf, device="cpu")
    got_sd, _ = load_reference_checkpoint(model, sd, num_anchors=A,
                                          num_classes=C)
    model.load_state_dict(got_sd, strict=True)
    offsets = [v for k, v in got_sd.items()
               if k.endswith("conv_offset_mask.weight")]
    assert len(offsets) == 8 and all(v.abs().max() > 0 for v in offsets)
    images = np.random.default_rng(5).normal(
        size=(2,) + CROP + (3,)).astype(np.float32)
    want = jmodel.apply(jvars, jnp.asarray(images), train=False)
    with torch.inference_mode():
        out = model(torch.from_numpy(images))
    for k in ("prob", "bbox_2d", "bbox_3d"):
        w = np.asarray(want[k])
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(out[k].numpy() / scale, w / scale,
                                   err_msg=k, **DEEP)

"""Learnability bisection probe, the port's counterpart of the reference
package's `scripts/learn_probe.py`.

It overfits a few fixed batches at the resolution and model of the
convergence run (`convergence_check.py`), toggling one fast-path knob per
variant, and reports each variant's acc_fg / loss trajectory, to find which
ingredient stops (or slows) learning. The batches are built once on the
host and stay on the card, so a step costs the step alone.

Variants:
  run2    the convergence run's semantics (bf16, s2d stem, shift DCN)
  run2aug the same over a pool of augmented batches
  f32     compute_dtype float32
  noshift the configuration's gather DCN (dcn_shift_clamp=None)
  nos2d   the conventional stem (stem_s2d=False)
  plain   float32, no s2d, no shift

    python -m m3dssd_tpu_torch.scripts.learn_probe --root /tmp/conv \
        --steps 1500 --variants run2,plain

reads `<root>/data`, the split `convergence_check` writes. `--in_memory`
draws that split's training scenes in memory instead (no image codec is
needed). Each variant ends with a `RESULT <name>: LEARNS|COLLAPSED ...`
line; LEARNS means acc_fg > 0.5 at the last step.
"""

from __future__ import annotations

import argparse
import copy
import os
import time

import numpy as np
import torch

VARIANTS = {
    "run2": {},
    "run2aug": {},
    "f32": {"compute_dtype": "float32"},
    "noshift": {"dcn_shift_clamp": None},
    "nos2d": {"stem_s2d": False},
    "plain": {"compute_dtype": "float32", "stem_s2d": False,
              "dcn_shift_clamp": None},
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m m3dssd_tpu_torch.scripts."
                                     "learn_probe")
    p.add_argument("--root", default="/tmp/conv")
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--images", type=int, default=16)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--backbone", default="dla34")
    p.add_argument("--crop", type=int, nargs=2, default=[384, 1280])
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--aug_pool", type=int, default=48,
                   help="augmented batch pool size for run2aug")
    p.add_argument("--variants", default="run2,plain")
    p.add_argument("--in_memory", action="store_true",
                   help="draw convergence_check's default training split in "
                        "memory instead of reading <root>/data (for a "
                        "machine without an image codec)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain ops) instead of the card")
    return p.parse_args(argv)


def make_conf(batch_size=4, backbone="dla34", crop=(384, 1280), lr=None):
    """The probe's base configuration: kitti_3d_base at the convergence
    run's size, anchors and whitening stats still to come from the split.
    Two settings differ from the reference script's: the loss keeps its
    logging stats (acc_fg, acc_bg, err_z), which the probe reads and
    conf.loss_light_stats would leave out (the training math is the same),
    and the gradient is clipped to the convergence run's global norm
    (convergence_check.GRAD_CLIP): without it the unbounded offsets of the
    gather-DCN variants grew until the loss went non-finite in some runs
    on the card."""
    from ..config import load_config
    from .convergence_check import GRAD_CLIP

    conf = load_config("kitti_3d_base").replace(
        back_bone=backbone, batch_size=batch_size, crop_size=list(crop),
        test_scale=list(crop), pre_train=False, num_workers=2,
        loss_light_stats=False, grad_clip_norm=GRAD_CLIP)
    if lr is not None:
        conf = conf.replace(lr=lr, lr_target=lr * 1e-5)
    return conf


def no_aug(conf):
    """`conf` with mirroring and translation off: identity batches."""
    return conf.replace(mirror_prob=0.0, trans_prob=0.0)


def variant_conf(conf, name: str):
    """The configuration of variant `name` over the base `conf`."""
    return no_aug(conf).replace(**VARIANTS[name])


def fixed_batches(dataset, images: int, batch_size: int):
    """max(images // batch_size, 1) deterministic (augmentation off)
    batches cycling over the images of `dataset` (a train set built with
    `no_aug(conf)`), as numpy dicts."""
    from ..data.loader import collate

    nb = max(images // batch_size, 1)
    n = len(dataset.imdb)
    rng = np.random.default_rng(0)      # nothing is drawn with aug off
    return [collate([dataset.sample(i % n, rng=rng)
                     for i in range(k * batch_size, (k + 1) * batch_size)])
            for k in range(nb)]


def to_device(batch, packed: bool, device):
    """A batch's tensors on `device`, images space-to-depth packed when
    `packed`."""
    from ..models.dla import space_to_depth

    out = {k: torch.as_tensor(v) for k, v in batch.items()}
    if packed:
        out["images"] = space_to_depth(out["images"]).contiguous()
    return {k: v.to(device) for k, v in out.items()}


def run_variant(conf, name: str, batches, rois, steps: int,
                log_every: int = 100, device=None, out=print, seed=0):
    """Train a fresh model of variant `name` (initialised from `seed`) for
    `steps` steps, cycling `batches` (kept on `device`). Prints the step
    lines and the RESULT line; returns the verdict, the last step's stats,
    the stats of each printed step, the count of steps with a non-finite
    stat, the steps per second and the trained TrainState."""
    from ..models import build
    from ..train.state import create_train_state, make_train_step
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    conf = variant_conf(conf, name)
    packed = bool(conf.stem_s2d)
    dev_batches = [to_device(b, packed, dev) for b in batches]
    model = build(conf, device=dev, seed=seed, phase="train")
    state = create_train_state(conf, model, steps)
    step_fn = make_train_step(conf, rois, packed_input=packed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    out(f"=== variant {name}: " + (", ".join(
        f"{k}={v}" for k, v in VARIANTS[name].items()) or "(defaults)"))
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    t0 = time.time()
    stats, logged = None, []
    for s in range(steps):
        stats = step_fn(state, dev_batches[s % len(dev_batches)], gen)
        vals = torch.stack([v.detach().float().reshape(())
                            for v in stats.values()])
        bad += (~torch.isfinite(vals)).any()
        if (s + 1) % log_every == 0 or s == 0:
            st = {k: float(v) for k, v in stats.items()}
            logged.append((s + 1, st))
            out(f"[{name}] step {s + 1} "
                f"loss={st['loss']:.4f} cls={st['loss_cls']:.4f} "
                f"acc_fg={st['acc_fg']:.3f} acc_bg={st['acc_bg']:.3f} "
                f"iou={st['iou']:.3f} err_z={st['err_z']:.3f} "
                f"({time.time() - t0:.0f}s)")
    st = {k: float(v) for k, v in stats.items()}
    rate = steps / (time.time() - t0)
    verdict = "LEARNS" if st["acc_fg"] > 0.5 else "COLLAPSED"
    out(f"RESULT {name}: {verdict} acc_fg={st['acc_fg']:.3f} "
        f"loss={st['loss']:.4f} iou={st['iou']:.3f} steps/s={rate:.2f}")
    return {"verdict": verdict, "stats": st, "logged": logged,
            "nonfinite_steps": int(bad), "steps_per_s": rate,
            "state": state}


def probe_data(conf, dataset, images: int):
    """(the base `conf` with the split's anchors and whitening stats,
    `dataset` cut to its first `images` images, the fixed batches over
    them); `dataset` is a train set built with `no_aug(conf)`."""
    base = conf.replace(anchors=dataset.conf.anchors,
                        bbox_means=dataset.conf.bbox_means,
                        bbox_stds=dataset.conf.bbox_stds)
    ds = copy.copy(dataset)
    ds.imdb = ds.imdb[:images]
    return base, ds, fixed_batches(ds, images, conf.batch_size)


def run_learn_probe(conf, dataset=None, data_root=None, cache=None,
                    variants=("run2", "plain"), steps: int = 1500,
                    images: int = 16, log_every: int = 100,
                    aug_pool: int = 48, device=None, out=print):
    """Run each of `variants` over the base `conf` (`make_conf`) on the
    first `images` images of the train split: `dataset` (built with
    `no_aug(conf)`, e.g. `convergence_check.in_memory_train_set`) or else
    `data_root`'s. Returns {variant: `run_variant`'s result}."""
    from ..data.augment import Augmentation
    from ..data.kitti import Kitti3DDataset
    from ..data.loader import TrainLoader
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        raise ValueError(f"unknown variants {unknown}; have {list(VARIANTS)}")
    if dataset is None:
        dataset = Kitti3DDataset(no_aug(conf), data_root, phase="train",
                                 cache_folder=cache)
    base, ds, fixed = probe_data(conf, dataset, images)
    out(f"built {len(fixed)} fixed batches")

    pool = None
    if "run2aug" in variants:
        ds_aug = copy.copy(ds)
        ds_aug.conf, ds_aug.transform = base, Augmentation(base)
        loader = TrainLoader(ds_aug, conf.batch_size, num_workers=2, seed=0,
                             upload_bf16=False, pin=False)
        t0 = time.time()
        pool = list(loader.batches(aug_pool))
        out(f"built {len(pool)} augmented batches in "
            f"{time.time() - t0:.0f}s")

    return {name: run_variant(base, name,
                              pool if name == "run2aug" else fixed,
                              ds.rois, steps, log_every, dev, out)
            for name in variants}


def main(argv=None):
    args = parse_args(argv)
    from ..utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    conf = make_conf(args.batch_size, args.backbone, args.crop, args.lr)
    dataset = None
    if args.in_memory:
        from .convergence_check import in_memory_train_set

        dataset = in_memory_train_set(no_aug(conf))
    log = lambda s: print(s, flush=True)    # noqa: E731
    run_learn_probe(conf, dataset=dataset,
                    data_root=os.path.join(args.root, "data"),
                    cache=os.path.join(args.root, "cache"),
                    variants=args.variants.split(","), steps=args.steps,
                    images=args.images, log_every=args.log_every,
                    aug_pool=args.aug_pool, device=device, out=log)


if __name__ == "__main__":
    main()

"""End-to-end convergence check at a realistic scale, the port's
counterpart of the reference package's `scripts/convergence_check.py`.

Trains a kitti_3d_base-shaped configuration (DLA-34 at 384x1280 with bf16,
the s2d stem and the shift-DCN necks all on) over a few-hundred-image
synthetic KITTI split, evaluating every few epochs, and ends with one
line, `CONVERGENCE_REPORT {...}`: the val AP trajectory, the AP on the
training split and the best val AP.

    python -m m3dssd_tpu_torch.scripts.convergence_check [--root /tmp/conv]
        [--epochs 40] [--num_train 240] [--num_val 40] [--eval_epoch 5]

Without `--in_memory` it writes the split under `<root>/data` (once; it
needs OpenCV to write the PNGs) and reads it back. With `--in_memory` it
draws the same scenes in memory (`data/synthetic.py`), for a machine
without an image codec. The run directory is `<root>/out`; `--resume`
continues from its latest checkpoint.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time

import numpy as np

SEED = 11
CLASSES = ("Car", "Pedestrian", "Cyclist")
MAX_OBJS = 6
NUM_TRAIN = 240
GRAD_CLIP = 5.0
KITTI_IM = (375, 1242)      # KITTI's image height and width


def _split_kw(crop):
    """The split's drawing arguments for a crop: KITTI-sized scenes, cut
    to the crop where it is smaller (the pipeline pads and warps, it never
    shrinks), the smallest box height (25 px at 375 rows) scaled alike."""
    imH, imW = (min(k, int(c)) for k, c in zip(KITTI_IM, crop))
    return dict(seed=SEED, imW=imW, imH=imH, classes=CLASSES,
                max_objs=MAX_OBJS,
                min_h_px=max(round(25 * imH / KITTI_IM[0]), 1))


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m m3dssd_tpu_torch.scripts."
                                     "convergence_check")
    p.add_argument("--root", default="/tmp/conv")
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--num_train", type=int, default=NUM_TRAIN)
    p.add_argument("--num_val", type=int, default=40)
    p.add_argument("--eval_epoch", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--lr", type=float, default=None,
                   help="override conf.lr (lr_target scales with it)")
    p.add_argument("--config", default="kitti_3d_base",
                   help="config name (kitti_3d_base | kitti_3d_anab | "
                        "kitti_3d_anab_fullalign)")
    p.add_argument("--backbone", default="dla34")
    p.add_argument("--crop", type=int, nargs=2, default=[384, 1280])
    p.add_argument("--host_targets", action="store_true",
                   help="compute the anchor targets on the host (default: "
                        "on the device, in the train step)")
    p.add_argument("--grad_clip", type=float, default=GRAD_CLIP,
                   help="global-norm gradient clip (0 = off)")
    p.add_argument("--pool", type=int, default=0,
                   help="draw this many augmented batches through the "
                        "trainer's loader once, keep them on the card and "
                        "cycle them (0 = stream from the loader)")
    p.add_argument("--stop_epoch", type=int, default=None,
                   help="stop after this epoch, keeping --epochs as the LR "
                        "schedule's horizon")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint of <root>/out")
    p.add_argument("--in_memory", action="store_true",
                   help="draw the split in memory instead of writing and "
                        "reading <root>/data (no image codec needed)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain ops) instead of the card")
    return p.parse_args(argv)


def make_conf(config="kitti_3d_base", epochs=40, eval_epoch=5, batch_size=4,
              backbone="dla34", crop=(384, 1280), host_targets=False,
              grad_clip=GRAD_CLIP, lr=None):
    """The convergence run's configuration; raises unless bf16, the s2d
    stem and the shift DCN are all on."""
    from ..config import load_config

    conf = load_config(config).replace(
        back_bone=backbone, batch_size=batch_size, crop_size=list(crop),
        test_scale=list(crop), pre_train=False, max_epoch=epochs,
        eval_epoch=eval_epoch, snapshot_epoch=max(epochs // 4, 1),
        display_iter=20, num_workers=4, score_thres=0.3,
        pre_compute_target=host_targets, sparse_align_train=True,
        grad_clip_norm=grad_clip or None)
    if lr is not None:
        conf = conf.replace(lr=lr, lr_target=lr * 1e-5)
    if not (conf.compute_dtype == "bfloat16" and conf.stem_s2d
            and conf.dcn_shift_clamp is not None):
        raise ValueError("the fast paths (bf16, s2d stem, shift DCN) must "
                         "be on")
    return conf


def conf_from_args(args):
    """`make_conf` with the CLI's flags."""
    return make_conf(args.config, args.epochs, args.eval_epoch,
                     args.batch_size, args.backbone, args.crop,
                     args.host_targets, args.grad_clip, args.lr)


def generate_split(data_root: str, num_train: int, num_val: int, crop):
    """Write the synthetic split for `crop` under `data_root` unless it is
    there."""
    from ..data.synthetic import generate

    if os.path.isdir(os.path.join(data_root, "kitti_split1")):
        return False
    generate(data_root, num_train=num_train, num_val=num_val,
             **_split_kw(crop))
    return True


def in_memory_train_set(conf, num_train: int = NUM_TRAIN):
    """The training scenes `generate_split` writes for conf.crop_size, in
    memory (anchors and whitening stats computed onto `conf` when it has
    none)."""
    from ..data.synthetic import SyntheticTrainSet

    return SyntheticTrainSet(conf, num_train, **_split_kw(conf.crop_size))


def in_memory_eval_sets(conf, num_train: int, num_val: int):
    """(val set, train-split eval set): the validation and the training
    scenes `generate_split` writes, as eval splits. `generate` draws the
    training scenes first and the validation scenes after them from one
    stream, so both come from one draw of num_train + num_val scenes."""
    from ..data.synthetic import SyntheticEvalSet

    both = SyntheticEvalSet(conf, num_train + num_val,
                            **_split_kw(conf.crop_size))
    val, train = copy.copy(both), copy.copy(both)
    train.scenes, val.scenes = both.scenes[:num_train], \
        both.scenes[num_train:]
    return val, train


class DevicePool:
    """Batches drawn once and cycled: `batches(n)` yields n of them, each
    picked uniformly with a seeded rng."""

    def __init__(self, batches, seed=0):
        self.pool = batches
        self.rs = np.random.default_rng(seed)

    def batches(self, n):
        for _ in range(n):
            yield self.pool[int(self.rs.integers(len(self.pool)))]


def run_convergence_check(conf, data_root, out: str, cache=None,
                          stop_epoch=None, resume: bool = False,
                          pool: int = 0, device=None, dataset=None,
                          val_dataset=None, train_eval_dataset=None,
                          log=print):
    """Train `conf` into the run directory `out`, recording the val AP at
    each eval, then evaluate the training split. `dataset` / `val_dataset`
    / `train_eval_dataset` take in-memory splits (`in_memory_train_set`,
    `in_memory_eval_sets`) instead of `data_root`'s. Returns (the report,
    the Trainer)."""
    from ..data.kitti import Kitti3DDataset
    from ..inference.detect import (make_batch_detector, make_detector,
                                    packed_input_eligible)
    from ..inference.test_driver import test_kitti_3d
    from ..train.trainer import Trainer
    from ..utils.checkpoint import latest_step, restore_checkpoint

    trainer = Trainer(conf, data_root, out, cache_folder=cache,
                      device=device, dataset=dataset,
                      val_dataset=val_dataset)
    conf = trainer.conf
    if resume:
        wdir = os.path.join(out, "weights")
        step = latest_step(wdir)
        if step:
            restore_checkpoint(wdir, trainer.state, step)
            log(f"resumed from step {step}")

    if pool:
        t0 = time.time()
        batches = [{k: v.to(trainer.device, non_blocking=True)
                    for k, v in b.items()}
                   for b in trainer.loader.batches(pool)]
        log(f"device pool: {len(batches)} batches uploaded in "
            f"{time.time() - t0:.0f}s")
        trainer.loader = DevicePool(batches, seed=conf.rng_seed)

    trajectory = []
    orig_eval = trainer._eval

    def eval_and_record(epoch):
        sel = orig_eval(epoch)
        trajectory.append({"epoch": epoch, "val_car_3d_r40": sel})
        log(f"[trajectory] epoch {epoch}: val Car 3D R40 = {sel:.2f}")
        return sel

    trainer._eval = eval_and_record
    trainer.run(stop_epoch)

    # the training split with the eval preprocessing (the train phase's
    # augmentation would move detections off the gt frame)
    results = os.path.join(out, "results", "train_split")
    if train_eval_dataset is None:
        train_eval_dataset = Kitti3DDataset(conf, data_root,
                                            phase="val_train")
        gt_path = os.path.join(data_root, conf.datasets_train[0]["name"],
                               "training", "label_2")
    else:
        gt_path = train_eval_dataset.write_labels(os.path.join(results,
                                                               "gt"))
    packed = packed_input_eligible(conf)
    eval_bs = max(int(getattr(conf, "eval_batch_size", 1)), 1)
    make = make_batch_detector if eval_bs > 1 else make_detector
    det = make(conf, trainer.dataset.rois, trainer.model,
               packed_input=packed, device=trainer.device)
    res_train, sel_train = test_kitti_3d(
        train_eval_dataset, det, conf, os.path.join(results, "data"),
        gt_path=gt_path, batch_size=eval_bs, packed_input=packed)
    # the 2D box AP is "image" in the eval's keys (there is no "bbox" key)
    bbox = (res_train or {}).get("Car_image_R40")
    report = {
        "val_trajectory": trajectory,
        "train_car_3d_r40": sel_train,
        "train_car_bbox_r40": None if bbox is None
        else np.asarray(bbox, np.float64).tolist(),
        "val_best": trainer.best_metric,
    }
    return report, trainer


def main(argv=None):
    args = parse_args(argv)
    from ..utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    log = lambda s: print(s, flush=True)    # noqa: E731
    conf = conf_from_args(args)
    data_root = os.path.join(args.root, "data")
    sets = {}
    if args.in_memory:
        sets["dataset"] = in_memory_train_set(conf, args.num_train)
        sets["val_dataset"], sets["train_eval_dataset"] = \
            in_memory_eval_sets(conf, args.num_train, args.num_val)
        log(f"synthetic KITTI in memory: {args.num_train} train / "
            f"{args.num_val} val")
    elif generate_split(data_root, args.num_train, args.num_val,
                        conf.crop_size):
        log(f"generated synthetic KITTI: {args.num_train} train / "
            f"{args.num_val} val")
    report, _ = run_convergence_check(
        conf, data_root, os.path.join(args.root, "out"),
        cache=os.path.join(args.root, "cache"), stop_epoch=args.stop_epoch,
        resume=args.resume, pool=args.pool, device=device, log=log, **sets)
    print("CONVERGENCE_REPORT " + json.dumps(report, default=float),
          flush=True)


if __name__ == "__main__":
    main()

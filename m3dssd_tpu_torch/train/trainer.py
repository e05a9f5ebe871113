"""The training driver: epochs, display, snapshots, periodic KITTI eval and
the best model.

The port's counterpart of the reference package's `train/trainer.py`, in
one process on one device. `Trainer(conf, data_root, output_dir)` reads the
KITTI-layout train and validation splits; `dataset=` / `val_dataset=` take
in-memory splits instead (`data.synthetic.SyntheticTrainSet`,
`SyntheticEvalSet`), for a machine without an image codec. Left out: the
reference's import of torch checkpoints of the original model, video
detection and the compilation cache.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Optional

import torch

from ..data.kitti import Kitti3DDataset
from ..data.loader import TrainLoader
from ..inference.detect import make_batch_detector, packed_input_eligible
from ..inference.test_driver import test_kitti_3d
from ..models import build
from ..utils.checkpoint import (restore_checkpoint, save_checkpoint,
                                wait_for_saves)
from ..utils.device import resolve_device
from ..utils.logging_utils import (StatTracker, compute_eta, init_logging,
                                   pretty_print)
from .state import create_train_state, make_train_step


class Trainer:
    def __init__(self, conf, data_root: Optional[str], output_dir: str,
                 cache_folder: Optional[str] = None, timestamped: bool = False,
                 device=None, dataset=None, val_dataset=None):
        self.conf = conf
        self.data_root = data_root
        self.device = resolve_device(device)
        if timestamped:
            output_dir = os.path.join(output_dir,
                                      time.strftime("%Y%m%d_%H%M%S"))
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        init_logging(os.path.join(output_dir, "log", "train.log"))
        logging.info("\n%s", pretty_print(
            "conf", {f.name: getattr(conf, f.name)
                     for f in dataclasses.fields(conf)}))

        self.dataset = dataset if dataset is not None else Kitti3DDataset(
            conf, data_root, phase="train", cache_folder=cache_folder)
        self.packed_input = bool(conf.stem_s2d and conf.crop_size[0] % 2 == 0
                                 and conf.crop_size[1] % 2 == 0)
        self.loader = TrainLoader(self.dataset, conf.batch_size,
                                  num_workers=conf.num_workers,
                                  seed=conf.rng_seed,
                                  pack_s2d=self.packed_input)
        self.steps_per_epoch = self.loader.steps_per_epoch
        self.max_iter = conf.max_epoch * self.steps_per_epoch
        conf.save(os.path.join(output_dir, "conf.pkl"))

        self.model = build(conf, device=self.device, seed=conf.rng_seed,
                           phase="train")
        self.state = create_train_state(conf, self.model, self.max_iter)
        self.train_step = make_train_step(conf, self.dataset.rois,
                                          packed_input=self.packed_input)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(conf.rng_seed)
        if conf.pretrained:
            if not os.path.isdir(conf.pretrained):
                raise NotImplementedError(
                    "importing a torch checkpoint of the original model is "
                    "not ported; conf.pretrained takes a port checkpoint "
                    "directory")
            restore_checkpoint(conf.pretrained, self.state)

        self.best_metric = -1.0
        self.val_dataset = val_dataset
        self._eval_detect = None
        self.writer = None
        self.last_stats = None
        self.last_eval = None

    def _gt_path(self) -> str:
        if hasattr(self.val_dataset, "write_labels"):
            return self.val_dataset.write_labels(
                os.path.join(self.output_dir, "results", "gt"))
        return os.path.join(self.data_root,
                            self.conf.datasets_validation[0]["name"],
                            "validation", "label_2")

    def _eval(self, epoch: int) -> float:
        """KITTI eval of the training model (switched to eval mode and
        back); returns the mean Car 3D AP-R40."""
        conf = self.conf
        if conf.test_protocol.lower() != "kitti":
            logging.warning("Testing protocol %s not understood; skipping "
                            "eval", conf.test_protocol)
            return -1.0
        if self.val_dataset is None:
            self.val_dataset = Kitti3DDataset(conf, self.data_root,
                                              phase="validation")
        packed = packed_input_eligible(conf)
        if self._eval_detect is None:
            self._eval_detect = make_batch_detector(
                conf, self.dataset.rois, self.model, packed_input=packed,
                device=self.device)
        results = os.path.join(self.output_dir, "results",
                               f"results_{epoch}", "data")
        self.model.eval()
        try:
            res, sel = test_kitti_3d(
                self.val_dataset, self._eval_detect, conf, results,
                gt_path=self._gt_path(),
                batch_size=max(int(conf.eval_batch_size), 1),
                packed_input=packed)
        finally:
            self.model.train()
        self.last_eval = res
        if res:
            logging.info("eval epoch %d: Car 3D R40 = %s", epoch,
                         res.get("Car_3d_R40"))
        return sel

    def run(self, epochs: Optional[int] = None):
        conf = self.conf
        epochs = epochs or conf.max_epoch
        tracker = StatTracker(writer=self.writer)
        t0 = time.time()
        it = self.state.step
        # resume: continue the epoch numbering and the eval / snapshot
        # cadence from the restored step (checkpoints fall on epoch ends)
        start_epoch = it // self.steps_per_epoch
        it0 = it
        for epoch in range(start_epoch, epochs):
            for batch in self.loader.batches(self.steps_per_epoch):
                stats = self.train_step(self.state, batch, self.generator)
                self.last_stats = stats
                tracker.update(stats)
                it += 1
                if it % max(int(conf.display_iter), 1) == 0:
                    eta, dt = compute_eta(t0, it - it0, self.max_iter - it0)
                    tracker.flush(it, extra=f"epoch {epoch} dt {dt:.3f}s "
                                            f"eta {eta}")
            if tracker.counts:
                eta, dt = compute_eta(t0, it - it0, self.max_iter - it0)
                tracker.flush(it, extra=f"epoch {epoch} end dt {dt:.3f}s "
                                        f"eta {eta}")
            if (epoch + 1) % conf.snapshot_epoch == 0 or epoch + 1 == epochs:
                save_checkpoint(os.path.join(self.output_dir, "weights"),
                                self.state, it, async_save=True)
            if conf.do_test and (epoch + 1) % conf.eval_epoch == 0:
                sel = self._eval(epoch + 1)
                if sel > self.best_metric:
                    self.best_metric = sel
                    save_checkpoint(os.path.join(self.output_dir,
                                                 "weights_best"),
                                    self.state, it, async_save=True)
                    logging.info("new best model: %.4f", sel)
        wait_for_saves()
        return self.state

    def finalize_run_dir(self) -> str:
        """Rename the run directory to `<output_dir>_<best metric>` when an
        eval produced one; returns the (possibly new) path."""
        if self.best_metric <= 0:
            return self.output_dir
        new_dir = f"{self.output_dir}_{self.best_metric:.4f}"
        os.rename(self.output_dir, new_dir)
        logging.info("run dir renamed: %s", new_dir)
        self.output_dir = new_dir
        return new_dir

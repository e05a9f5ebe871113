"""The training driver: epochs, display, snapshots, periodic KITTI eval and
the best model.

The port's counterpart of the reference package's `train/trainer.py`.
`Trainer(conf, data_root, output_dir)` reads the KITTI-layout train and
validation splits; `dataset=` / `val_dataset=` take in-memory splits
instead (`data.synthetic.SyntheticTrainSet`, `SyntheticEvalSet`), for a
machine without an image codec. At start the
run directory gets the resolved config (`conf.pkl`) and a snapshot of the
package source (`model_src/`, utils/source_snapshot.py). `conf.pretrained`
names a seed checkpoint directory (weights only, fresh optimizer), a
checkpoint directory of the port, or a .pth/.pkl checkpoint of the
original model (utils/torch_import.py). Left out: video detection and the
compilation cache.

Under torch.distributed (one process per card, `parallel/mesh.py`) the
Trainer trains over a mesh of `conf.dp_devices` data ranks (or else the
largest divisor of the batch size that fits the world), each of
conf.mesh_spatial x conf.mesh_model ranks, as the reference sizes its
mesh. Each data rank decodes only its rows of every global batch; the
step is the single-process step on the global batch.
Rank 0 alone writes conf.pkl, the source snapshot, the checkpoints and
the eval's txts; the other ranks log to log/train.p<rank>.log. Every rank
takes part in the periodic eval and takes the same best-model branch.
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
from ..parallel.mesh import (barrier, make_mesh, per_host_data_slicing_ok,
                             replicate_state, world)
from ..utils.checkpoint import (is_seed_checkpoint, restore_checkpoint,
                                restore_seed, save_checkpoint,
                                wait_for_saves, whole_state)
from ..utils.device import resolve_device
from ..utils.logging_utils import (StatTracker, compute_eta, init_logging,
                                   pretty_print)
from ..utils.profiling import make_tb_writer
from ..utils.source_snapshot import snapshot_source
from ..utils.torch_import import (load_reference_checkpoint,
                                  load_torch_file, pin_parity_conf,
                                  reference_block)
from .state import create_train_state, make_train_step


def data_parallel_size(conf, world_size: int) -> int:
    """The data axis's size: conf.dp_devices when set, else the largest
    divisor of the global batch size that fits the world's ranks over
    conf.mesh_spatial x conf.mesh_model (the axis splits every batch
    evenly), as the reference sizes its mesh. Logs a warning when the mesh
    leaves ranks idle, and raises when it is one rank under several
    processes: they would each train apart."""
    per = max(int(conf.mesh_spatial), 1) * max(int(conf.mesh_model), 1)
    if conf.dp_devices > 0:
        dp = int(conf.dp_devices)
    else:
        fit = max(world_size // per, 1)
        dp = max(d for d in range(1, fit + 1) if conf.batch_size % d == 0)
    n = dp * per
    if n > world_size:
        raise ValueError(f"a mesh of {dp} x {per} ranks in a world of "
                         f"{world_size}")
    if n == 1 and world_size > 1:
        raise ValueError(
            f"a data axis of 1 under {world_size} processes would train "
            "each process apart: set conf.dp_devices, or a batch size "
            f"({conf.batch_size}) with a divisor above 1 that fits them")
    if n < world_size:
        logging.warning("a mesh of %d ranks in a world of %d: ranks "
                        "%d and above idle", n, world_size, n)
    return dp


class Trainer:
    def __init__(self, conf, data_root: Optional[str], output_dir: str,
                 cache_folder: Optional[str] = None, timestamped: bool = False,
                 device=None, dataset=None, val_dataset=None):
        self.data_root = data_root
        self.device = resolve_device(device)
        # a checkpoint of the original model with learned neck offsets
        # pins the unbounded gather DCN, before the model is built and the
        # conf is saved with the run
        self._pretrained_sd = None
        if conf.pretrained and not os.path.isdir(conf.pretrained):
            self._pretrained_sd = load_torch_file(conf.pretrained)
            conf = pin_parity_conf(conf, self._pretrained_sd)
        self.conf = conf
        if timestamped:
            output_dir = os.path.join(output_dir,
                                      time.strftime("%Y%m%d_%H%M%S"))
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        rank, world_size = world()
        init_logging(os.path.join(output_dir, "log", "train.log" if rank == 0
                                  else f"train.p{rank}.log"))
        logging.info("\n%s", pretty_print(
            "conf", {f.name: getattr(conf, f.name)
                     for f in dataclasses.fields(conf)}))
        # the data axis comes before the loader, which slices each global
        # batch per process
        self.mesh = None
        if world_size > 1:
            sp, mp = max(conf.mesh_spatial, 1), max(conf.mesh_model, 1)
            self.mesh = make_mesh(data_parallel_size(conf, world_size)
                                  * sp * mp, sp, mp, device=self.device)
            m = self.mesh
            logging.info("mesh: rank %d at data %d of %d, spatial %d of %d, "
                         "model %d of %d", rank, m.rank, m.size, m.s,
                         m.spatial, m.m, m.model)
        self.primary = rank == 0
        sliced = per_host_data_slicing_ok(self.mesh)

        self.dataset = dataset if dataset is not None else Kitti3DDataset(
            conf, data_root, phase="train", cache_folder=cache_folder)
        self.packed_input = bool(conf.stem_s2d and conf.crop_size[0] % 2 == 0
                                 and conf.crop_size[1] % 2 == 0)
        self.loader = TrainLoader(
            self.dataset, conf.batch_size, num_workers=conf.num_workers,
            seed=conf.rng_seed, pack_s2d=self.packed_input,
            process_index=self.mesh.rank if sliced else 0,
            process_count=self.mesh.size if sliced else 1)
        self.steps_per_epoch = self.loader.steps_per_epoch
        self.max_iter = conf.max_epoch * self.steps_per_epoch
        if self.primary:
            conf.save(os.path.join(output_dir, "conf.pkl"))
            snapshot_source(output_dir)

        mesh = self.mesh if self.mesh is not None and self.mesh.member \
            else None
        self.model = build(conf, device=self.device, seed=conf.rng_seed,
                           phase="train", mesh=mesh)
        self.state = create_train_state(conf, self.model, self.max_iter)
        self.train_step = make_train_step(conf, self.dataset.rois,
                                          packed_input=self.packed_input,
                                          mesh=mesh)
        # one seed on every rank: the loss's random sampling draws the
        # global batch's scores from it
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(conf.rng_seed)
        if conf.pretrained:
            self._load_pretrained(conf.pretrained)
        if self.mesh is not None and self.mesh.member:
            replicate_state(self.mesh, self.state)

        self.best_metric = -1.0
        self.val_dataset = val_dataset
        self._eval_detect = None
        self.writer = make_tb_writer(os.path.join(output_dir, "log", "tb")) \
            if self.primary else None
        self.last_stats = None
        self.last_eval = None

    def _load_pretrained(self, path: str):
        """Weights from `path`: a seed checkpoint directory (parameters and
        BN statistics; the optimizer and step stay fresh), a checkpoint
        directory (model, optimizer and step), or a checkpoint file of the
        original model (matched by name and shape, the rest reported)."""
        if os.path.isdir(path):
            if is_seed_checkpoint(path):
                restore_seed(path, self.model)
            else:
                restore_checkpoint(path, self.state)
            return
        conf = self.conf
        sd, _ = load_reference_checkpoint(
            self.model, self._pretrained_sd,
            num_anchors=conf.anchors.shape[0],
            num_classes=conf.num_classes,
            block=reference_block(conf.back_bone))
        self.model.load_state_dict(sd, strict=True)

    def _gt_path(self) -> Optional[str]:
        if not self.primary:
            return None
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
                packed_input=packed, mesh=self.mesh)
        finally:
            self.model.train()
        self.last_eval = res
        if res:
            logging.info("eval epoch %d: Car 3D R40 = %s", epoch,
                         res.get("Car_3d_R40"))
            if self.writer is not None:
                for key, vals in res.items():
                    if key.startswith("_"):
                        continue
                    for d, name in zip(vals, ["easy", "moderate", "hard"]):
                        self.writer.add_scalar(f"Test/{key}/{name}", d,
                                               epoch)
        return sel

    def run(self, epochs: Optional[int] = None):
        conf = self.conf
        if self.mesh is not None and not self.mesh.member:
            return self.state
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
                self._save("weights", it)
            if conf.do_test and (epoch + 1) % conf.eval_epoch == 0:
                sel = self._eval(epoch + 1)
                if sel > self.best_metric:
                    self.best_metric = sel
                    self._save("weights_best", it)
                    logging.info("new best model: %.4f", sel)
        wait_for_saves()
        if self.writer is not None:
            self.writer.flush()
        # every checkpoint is on disk before any rank goes on to read one
        barrier(self.mesh)
        return self.state

    def _save(self, name: str, it: int):
        """Checkpoint the state into <run>/<name> on rank 0, in the
        one-process layout (every rank takes part in gathering the model
        axis's slices)."""
        whole = whole_state(self.state)
        if self.primary:
            save_checkpoint(os.path.join(self.output_dir, name), self.state,
                            it, async_save=True, whole=whole)

    def whole_model_state(self):
        """The model's state dict with whole tensors (every rank calls
        it)."""
        return whole_state(self.state)[0]

    def finalize_run_dir(self) -> str:
        """Rename the run directory to `<output_dir>_<best metric>` when an
        eval produced one (rank 0 only); returns the (possibly new) path."""
        if self.best_metric <= 0 or not self.primary:
            return self.output_dir
        if self.writer is not None:
            self.writer.close()
            self.writer = None
        new_dir = f"{self.output_dir}_{self.best_metric:.4f}"
        os.rename(self.output_dir, new_dir)
        logging.info("run dir renamed: %s", new_dir)
        self.output_dir = new_dir
        return new_dir

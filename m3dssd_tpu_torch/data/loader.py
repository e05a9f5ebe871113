"""Host input pipeline of training: weighted sampling, threaded prefetch and
batching into pinned torch tensors.

The port's counterpart of the reference package's `data/loader.py`.
Per-sample work (decode, augment, anchor targets) runs in a thread pool,
the numpy parts release the GIL, and finished batches wait in a bounded
queue, so host preparation overlaps the device's steps. Each sample's augmentation draws from its own numpy
Generator seeded by (seed, draw, slot), so batches do not depend on which
thread ran first. Under data parallelism (`process_count` > 1) every
process draws the same global indices and decodes only its own rows,
seeded by their global slots, so its batch is bit-equal to those rows of
the single-process batch.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from .. import geometry as geo


def balance_samples(conf, imdb) -> np.ndarray:
    """Image sampling weights by fg / empty status (conf.fg_image_ratio)."""
    weights = np.ones(len(imdb))
    if conf.fg_image_ratio >= 0:
        valid_inds, empty_inds = [], []
        for i, imobj in enumerate(imdb):
            scale = conf.test_scale[0] / imobj.imH
            igns, rmvs = geo.determine_ignores(imobj.gts, conf.lbls, conf.ilbls,
                                               conf.min_gt_vis, conf.min_gt_h,
                                               conf.max_gt_h, scale)
            valid = int(((~igns) & (~rmvs)).sum())
            weights[i] = valid
            (valid_inds if valid > 0 else empty_inds).append(i)
        if conf.fg_image_ratio != 2:
            if valid_inds:
                weights[valid_inds] = len(imdb) * conf.fg_image_ratio \
                    / len(valid_inds)
            if empty_inds:
                weights[empty_inds] = len(imdb) * (1 - conf.fg_image_ratio) \
                    / len(empty_inds)
    s = weights.sum()
    if s <= 0:
        weights[:] = 1.0 / len(weights)
    else:
        weights /= s
    return weights


def collate(samples) -> Dict[str, np.ndarray]:
    """Stack per-image samples into the batch arrays the train step takes:
    images [B,H,W,3] float32; labels [B,N] int32; labels_fg/bg/ign [B,N]
    int8; bbox_2d [B,4,N] and bbox_3d [B,7,N] float32 (channel-major);
    any_val [B] int32; p2_inv [B,4,4] float32. Samples of the on-device
    target path carry padded gts instead of the targets: gt_boxes2d
    [B,G,4], gt_boxes3d [B,G,11], gt_cls [B,G], gt_valid [B,G], ign_boxes
    [B,G,4], ign_valid [B,G]."""
    batch = {"images": np.stack([s["input"] for s in samples], axis=0)}
    if "target" in samples[0]:
        for k in samples[0]["target"]:
            batch[k] = np.stack([np.asarray(s["target"][k])
                                 for s in samples], axis=0)
        for k in ("bbox_2d", "bbox_3d"):
            batch[k] = np.ascontiguousarray(batch[k].transpose(0, 2, 1))
    else:
        for k in samples[0]["gt"]:
            batch[k] = np.stack([s["gt"][k] for s in samples], axis=0)
    batch["p2_inv"] = np.stack(
        [np.asarray(s["meta"]["p2_inv"], np.float32) for s in samples], 0)
    return batch


class TrainLoader:
    """Weighted-random, threaded, prefetching batch iterator.

    `batches(n)` yields n dicts of CPU tensors (pinned when a card is
    present, so `train_step` uploads them without blocking). With
    `pack_s2d` the images are space-to-depth packed ([B,H/2,W/2,12]); with
    `upload_bf16` (default: conf.compute_dtype is bfloat16) they are cast to
    bfloat16, which the model would do on the card anyway. `batch_size` is
    the global batch; with `process_count` > 1 this process yields rows
    [p B/n, (p+1) B/n) of it (p = `process_index`).
    """

    def __init__(self, dataset, batch_size: int, num_workers: int = 8,
                 seed: int = 0, prefetch: int = 4,
                 weights: Optional[np.ndarray] = None,
                 pack_s2d: bool = False, upload_bf16: Optional[bool] = None,
                 pin: Optional[bool] = None, process_index: int = 0,
                 process_count: int = 1):
        if batch_size % process_count:
            raise ValueError(f"a global batch of {batch_size} over "
                             f"{process_count} processes")
        self.dataset = dataset
        self.batch_size = batch_size
        self.local_batch = batch_size // process_count
        self.row0 = process_index * self.local_batch
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self._draws = 0     # batch draws so far, keys the per-sample rngs
        self.weights = weights if weights is not None else balance_samples(
            dataset.conf, dataset.imdb)
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.pack_s2d = pack_s2d
        if upload_bf16 is None:
            upload_bf16 = dataset.conf.compute_dtype == "bfloat16"
        self.upload_bf16 = upload_bf16
        self.pin = torch.cuda.is_available() if pin is None else pin
        self.steps_per_epoch = max(1, len(dataset) // batch_size)

    def _sample_indices(self) -> np.ndarray:
        return self.rng.choice(len(self.dataset), size=self.batch_size,
                               replace=True, p=self.weights)

    def _tensors(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        out = {k: torch.from_numpy(v) for k, v in batch.items()}
        if self.pack_s2d:
            from ..models.dla import space_to_depth

            out["images"] = space_to_depth(out["images"]).contiguous()
        if self.upload_bf16:
            out["images"] = out["images"].to(torch.bfloat16)
        if self.pin:
            out = {k: v.pin_memory() for k, v in out.items()}
        return out

    def batches(self, num_steps: int) -> Iterator[Dict[str, torch.Tensor]]:
        """Yield `num_steps` batches with background prefetch."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for _ in range(num_steps):
                        if stop.is_set():
                            return
                        idx = self._sample_indices()
                        draw = self._draws
                        self._draws += 1
                        lo = self.row0
                        args = [(int(i), np.random.default_rng(
                            (self.seed, draw, lo + s)))
                            for s, i in enumerate(
                                idx[lo:lo + self.local_batch])]
                        samples = list(pool.map(
                            lambda a: self.dataset.sample(a[0], rng=a[1]),
                            args))
                        q.put(self._tensors(collate(samples)))
            except BaseException as e:      # surfaced by the consumer
                q.put(e)
                return
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            for _ in range(num_steps):
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # unblock a producer waiting on a full queue, then let it end
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass


class EvalLoader:
    """Sequential bs=1 iterator over an eval dataset's samples."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __iter__(self):
        for i in range(len(self.dataset)):
            yield self.dataset[i]

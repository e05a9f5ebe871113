"""Where the PyTorch port's eval loop spends its host time on one CUDA card.

    python3 profile_eval.py [--rounds 2]

Sets up `chip_smoke.py`'s eval run (the flagship, bf16, 384x1280 bs=8, 64
synthetic 375x1242 images, as many detections per image as the split has
gt objects) and times, in turns, `--rounds` times each:

- the driver's loop (`test_driver._run_batched`) with 8 prefetch threads
  (the driver's), with 4, and with pageable instead of pinned packs;
- the same loop with the post-process and the writes in one spawned
  process, which takes batch k while the main thread detects batch k+1;
- the host steps of one image alone, on one thread: read (preprocess),
  pack with the pinned copy (the driver's) and pack without it.

Every loop must write the bytes of the driver's. Prints the card's name
and power limit beside the numbers. Needs a card.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import sys
import tempfile
import time
from collections import deque
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch


def _post_batch(conf, arr, metas, results_path):
    """Post-process and write one batch; runs in the worker process."""
    from m3dssd_tpu_torch.inference import test_driver as drv

    for j, (p2, iid) in enumerate(metas):
        rows = drv.postprocess_dets(conf, arr[j], p2, np.linalg.inv(p2))
        drv.write_kitti_result(os.path.join(results_path, iid + ".txt"),
                               rows)


def loop_post_process(ev, results_path, worker, batch_size,
                      prefetch_workers=8):
    """The driver's loop, but the post-process and writes of batch k go to
    `worker` (a one-process pool) while the main thread detects k+1."""
    data, B, n = ev.data, batch_size, len(ev.data)

    def load(i):
        s = data[i]
        return (ev.pack(s["input"]), float(s["meta"]["scale_factor"]),
                s["meta"])

    pending = None
    with ThreadPoolExecutor(max_workers=prefetch_workers) as pool:
        window = max(2 * B, prefetch_workers + 1)
        futures = deque(pool.submit(load, i) for i in range(min(window, n)))
        next_i = len(futures)
        for start in range(0, n, B):
            ims, sfs, metas = [], [], []
            for _ in range(min(B, n - start)):
                im, sf, meta = futures.popleft().result()
                if next_i < n:
                    futures.append(pool.submit(load, next_i))
                    next_i += 1
                ims.append(im)
                sfs.append(sf)
                metas.append((meta["p2"], meta["id"]))
            imb = torch.empty((B,) + tuple(ims[0].shape[1:]),
                              dtype=ims[0].dtype, device=ev.device)
            for j in range(B):
                imb[j:j + 1].copy_(ims[min(j, len(ims) - 1)],
                                   non_blocking=True)
            sfs += sfs[-1:] * (B - len(sfs))
            sfb = torch.tensor(sfs, dtype=torch.float32).to(ev.device)
            dets = ev.detect(imb, sfb)
            arr = dets.reshape(B, -1, dets.shape[-1]).cpu().numpy()
            if pending is not None:
                pending.result()
            pending = worker.submit(_post_batch, ev.conf, arr, metas,
                                    results_path)
        if pending is not None:
            pending.result()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_eval: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from m3dssd_tpu_torch.inference import test_driver as drv

    label = cs.card_label()
    B, n = cs.EVAL_BATCH, cs.EVAL_IMAGES
    ev = cs.eval_setup("cuda")
    conf, data = ev.conf, ev.data
    unpinned = drv._packer(conf, packed_input=True, pin=False)
    spawn = multiprocessing.get_context("spawn")

    with tempfile.TemporaryDirectory() as tmp, \
            ProcessPoolExecutor(max_workers=1, mp_context=spawn) as worker:
        ref = os.path.join(tmp, "ref")
        os.makedirs(ref)
        drv._run_batched(data, ev.detect, conf, drv.txt_writer(ref), B, ev.pack, ev.device)
        want = cs.read_txts(ref)
        # start the worker and its imports before any timing
        worker.submit(_post_batch, conf, np.zeros((0, 0, 14)), [],
                      ref).result()

        loops = {
            "driver, 8 prefetch threads": lambda d: drv._run_batched(
                data, ev.detect, conf, drv.txt_writer(d), B, ev.pack,
                ev.device),
            "driver, 4 prefetch threads": lambda d: drv._run_batched(
                data, ev.detect, conf, drv.txt_writer(d), B, ev.pack,
                ev.device, prefetch_workers=4),
            "driver, pageable packs": lambda d: drv._run_batched(
                data, ev.detect, conf, drv.txt_writer(d), B, unpinned,
                ev.device),
            "post-process in a spawned process": lambda d: loop_post_process(
                ev, d, worker, B),
        }
        times = {k: [] for k in loops}
        for r in range(args.rounds):
            order = list(loops) if r % 2 == 0 else list(loops)[::-1]
            for k, name in enumerate(order):
                d = os.path.join(tmp, f"run{r}-{k}")
                os.makedirs(d)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loops[name](d)
                times[name].append(time.perf_counter() - t0)
                cs.check(cs.read_txts(d) == want,
                         f"{name}: wrote other bytes than the driver")

    # one image's host steps alone, on this thread
    inputs = [data[i]["input"] for i in range(n)]
    steps = {"read (preprocess)": lambda i: data[i],
             "pack, pinned (the driver's)": lambda i: ev.pack(inputs[i]),
             "pack, pageable": lambda i: unpinned(inputs[i])}
    step_ms = {k: [] for k in steps}
    for r in range(args.rounds):
        order = list(steps) if r % 2 == 0 else list(steps)[::-1]
        for name in order:
            t0 = time.perf_counter()
            for i in range(n):
                steps[name](i)
            step_ms[name].append((time.perf_counter() - t0) * 1e3 / n)

    print(f"card: {label}")
    print(f"eval loop {cs.EVAL_CROP[0]}x{cs.EVAL_CROP[1]} bs={B}, {n} "
          f"synthetic {cs.EVAL_IM[0]}x{cs.EVAL_IM[1]} images, "
          f"{ev.det_per_image:.3f} detections per image "
          f"({ev.gt_per_image:.3f} gt objects), in turns, "
          f"{args.rounds} runs each (im/s per run; all wrote the same "
          "bytes):")
    for name, ts in times.items():
        print(f"  {name:36s} " + ", ".join(f"{n / t:.2f}" for t in ts))
    print("one image's host steps on one thread (ms per image per run):")
    for name, ms in step_ms.items():
        print(f"  {name:36s} " + ", ".join(f"{v:.3f}" for v in ms))
    return 0


if __name__ == "__main__":
    sys.exit(main())

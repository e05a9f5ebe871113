"""Data-parallel train step of the flagship over the processes torchrun
starts, one per card:

    python -m torch.distributed.run --standalone --nproc_per_node 4 \
        profile_dp.py [--batch 8] [--steps 10]

Each rank builds the flagship (kitti_3d_anab_fullalign, DLA-102, bf16,
384x1280, seeded weights, BatchNorm over the global batch) and takes its
rows of each global batch of `--batch` from a sliced TrainLoader over an
in-memory synthetic split; every step reduces the gradients over NCCL.
Rank 0 prints the card, then one JSON line: ranks, global batch, ms per
step (median of the timed steps, all ranks synchronised), images/s, the
all-reduce of the gradients alone, and each rank's launches of the
shift-DCN kernels and peak memory. `--trace N` then runs N more steps
under `torch.profiler` on every rank, and rank 0 prints its wall time per
step under the profiler, the device time of its compute kernels and of
its NCCL kernels per step, the compute stream's idle share and the
kernels that take the most time. `--cpu` runs a tiny dla34 model on the
CPU over gloo (a rehearsal, no timing worth keeping).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args()

    from m3dssd_tpu_torch.config import flagship_conf
    from m3dssd_tpu_torch.data.loader import TrainLoader
    from m3dssd_tpu_torch.data.synthetic import SyntheticTrainSet
    from m3dssd_tpu_torch.models import build
    from m3dssd_tpu_torch.ops import dcn_cuda
    from m3dssd_tpu_torch.parallel import (all_reduce_grads,
                                           init_distributed, make_mesh)
    from m3dssd_tpu_torch.train.state import (create_train_state,
                                              make_train_step)

    device = "cpu" if args.cpu else None
    init_distributed(device=device)
    mesh = make_mesh(device=device)
    if args.cpu:
        torch.set_num_threads(1)
        crop, im, kw = (64, 224), dict(imW=224, imH=64, min_h_px=6), dict(
            num_scales=2, backbone="dla34", dtype="float32")
    else:
        crop, im, kw = (384, 1280), dict(imW=1242, imH=375), {}
    conf = flagship_conf(crop, **kw).replace(
        anchors=None, bbox_means=None, bbox_stds=None,
        batch_size=args.batch, warmup=0.0, lr=0.002)
    ds = SyntheticTrainSet(conf, 64, seed=7, **im)
    loader = TrainLoader(ds, args.batch, num_workers=8, seed=0,
                         pack_s2d=True, process_index=mesh.rank,
                         process_count=mesh.size)
    batches = list(loader.batches(2))
    model = build(conf, device=mesh.device, seed=0, phase="train",
                  group=mesh.group)
    state = create_train_state(conf, model, max_iter=10 ** 6)
    step = make_train_step(conf, ds.rois, packed_input=True,
                           group=mesh.group)

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        dist.barrier(group=mesh.group)

    for i in range(2):
        step(state, batches[i % 2])
    sync()
    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mesh.device)
    dcn_cuda.launches = 0
    for k in dcn_cuda.bwd_launches:
        dcn_cuda.bwd_launches[k] = 0
    times = []
    for i in range(args.steps):
        sync()
        t0 = time.perf_counter()
        stats = step(state, batches[i % 2])
        float(stats["loss"])
        sync()
        times.append(time.perf_counter() - t0)
    grads = [torch.zeros_like(p) for p in model.parameters()]
    reduce_s = []
    for _ in range(5):
        sync()
        t0 = time.perf_counter()
        nbytes = all_reduce_grads(grads, mesh.group)
        sync()
        reduce_s.append(time.perf_counter() - t0)
    mine = {"rank": mesh.rank,
            "launches": {"forward": dcn_cuda.launches,
                         **dcn_cuda.bwd_launches},
            "peak_gib": (torch.cuda.max_memory_allocated(mesh.device)
                         / 2 ** 30 if mesh.device.type == "cuda" else None)}
    ranks = [None] * mesh.size
    dist.all_gather_object(ranks, mine, group=mesh.group)
    if mesh.primary:
        if mesh.device.type == "cuda":
            print(subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60).stdout.strip(), flush=True)
        ms = 1e3 * sorted(times)[len(times) // 2]
        print(json.dumps({
            "ranks": mesh.size, "backend": dist.get_backend(),
            "device": (torch.cuda.get_device_name(mesh.device)
                       if mesh.device.type == "cuda" else "cpu"),
            "global_batch": args.batch, "rows_per_rank": args.batch
            // mesh.size, "ms_per_step": ms,
            "im_per_s": args.batch * 1e3 / ms,
            "steps_ms": [1e3 * t for t in times],
            "reduced_bytes": nbytes,
            "allreduce_ms": 1e3 * sorted(reduce_s)[len(reduce_s) // 2],
            "per_rank": ranks}), flush=True)
    if args.trace:
        trace(args.trace, step, state, batches, sync, mesh)
    dist.destroy_process_group()


def trace(n, step, state, batches, sync, mesh):
    """`n` steps under torch.profiler; rank 0 prints where the device time
    goes."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            step(state, batches[i % 2])
        sync()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n
    if not mesh.primary:
        return
    kernels = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        # "nccl:<op>" records the collective's range, whose device time
        # is its kernel's again
        if (us > 0 and e.device_type == torch.autograd.DeviceType.CUDA
                and not e.key.startswith("nccl:")):
            kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3 / n
    nccl = sum(ms for k, ms in kernels.items() if "nccl" in k.lower())
    busy = sum(kernels.values()) - nccl
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({
        "ranks": mesh.size, "traced_steps": n, "wall_ms": wall_ms,
        "compute_kernels_ms": busy, "nccl_kernels_ms": nccl,
        "compute_idle_share": max(0.0, 1 - busy / wall_ms),
        "top_ms": {k[:90]: ms for k, ms in top}}), flush=True)


if __name__ == "__main__":
    main()

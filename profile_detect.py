"""Where the PyTorch port's detect time goes on one CUDA card.

    python3 profile_detect.py [--crop 512 1760] [--batch 8] [--bg_bias 4.0]
        [--iters 5] [--json FILE] [--root DIR] [--wall ROUNDS]
        [--graph_forms]

Builds the flagship detector as `chip_smoke.py` does (DLA-102, bf16, seeded
weights, random neck offsets), warms it up, then traces `--iters` calls of
`make_batch_detector` with `torch.profiler` and prints the wall time per
call, the device's busy and idle shares, and the kernels that take the
most device time, grouped by what they do. Needs a card; prints the card's
name and power limit beside every number.

With `--wall ROUNDS` it skips the profiler and prints the wall time per
call (host clock, synchronised, `--iters` calls) of ROUNDS readings, for
comparing two trees: `--root DIR` imports the port from DIR (an unpacked
`git archive` of another commit in a git-ignored directory) instead of
the checkout beside this script; run the two in turns (A, B, B, A) in one
call. With `--wall` and `--graph_forms` one process times eager detect in
both forms of `ops/control.py`, in turns (read-back, graph, graph,
read-back) each reading: the read-back of the branch flags that eager runs
take, and the graph operators (`torch.cond`, `while_loop`) that export
traces, run eagerly (this script makes `control.tracing` answer True).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

GROUPS = (("shift-DCN kernel", ("dcn_shift",)),
          ("convolution", ("conv", "cudnn", "xmma", "implicit", "winograd",
                           "fft", "dgrad", "wgrad", "fprop")),
          ("matmul", ("gemm", "cutlass", "matmul")),
          ("gather / scatter / index", ("index", "gather", "scatter",
                                        "take")),
          ("reduction / argmax / sort", ("reduce", "argmax", "max", "sort",
                                         "scan", "cumsum", "search")),
          ("copy / layout", ("copy", "cat", "permute", "contiguous",
                             "transpose", "memcpy", "memset", "fill")),
          ("elementwise", ("elementwise", "vectorized", "unrolled")))
TOP = 15


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--crop", type=int, nargs=2, default=(512, 1760))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--bg_bias", type=float, default=None,
                    help="raise the background logit (trained-detector "
                    "confidence regime)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--json", default=None,
                    help="also write the breakdown to this file")
    ap.add_argument("--root", default=None,
                    help="import the port from this tree")
    ap.add_argument("--wall", type=int, default=0,
                    help="readings of the wall time per call, no profiler")
    ap.add_argument("--graph_forms", action="store_true",
                    help="with --wall: time the read-back and the graph "
                    "forms of ops/control.py in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_detect: no CUDA card", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    import chip_smoke as cs
    from m3dssd_tpu_torch.anchors import locate_anchors
    from m3dssd_tpu_torch.config import flagship_conf
    from m3dssd_tpu_torch.inference.detect import make_batch_detector
    from m3dssd_tpu_torch.models import bias_background, build
    from torch.profiler import ProfilerActivity, profile

    label = cs.card_label()
    crop, B = tuple(args.crop), args.batch
    conf = flagship_conf(crop)
    model = cs.perturb_neck_offsets(build(conf, seed=0), seed=1)
    if args.bg_bias is not None:
        bias_background(model, conf.num_classes, args.bg_bias)
    rois = locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    detect = make_batch_detector(conf, rois, model, packed_input=True)
    images = cs.packed_images(B, crop[0], crop[1], seed=2, device="cuda")
    sfs = torch.ones(B, device="cuda")

    def use(graph):
        if args.graph_forms:     # (a tree before the graph forms has none)
            from m3dssd_tpu_torch.ops import control
            control.tracing = (lambda: True) if graph else \
                torch.compiler.is_exporting

    forms = (False, True) if args.graph_forms else (False,)
    outs = {}
    for graph in forms:
        use(graph)
        for _ in range(2):
            outs[graph] = detect(images, sfs)
    torch.cuda.synchronize()
    use(False)
    if args.graph_forms and not torch.equal(outs[False], outs[True]):
        print("profile_detect: the graph forms give other dets",
              file=sys.stderr)
        return 1
    tag = (f"{crop[0]}x{crop[1]} bs={B}"
           + ("" if args.bg_bias is None else f" bg_bias {args.bg_bias}"))
    if args.wall:
        import m3dssd_tpu_torch

        reads = {graph: [] for graph in forms}
        turns = (False, True, True, False) if args.graph_forms else (False,)
        for _ in range(args.wall):
            for graph in turns:
                use(graph)
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    detect(images, sfs)
                torch.cuda.synchronize()
                reads[graph].append((time.perf_counter() - t0) * 1e3
                                    / args.iters)
        use(False)
        print(f"card: {label}")
        for graph, v in reads.items():
            form = ("graph forms" if graph else "read-back") \
                if args.graph_forms else ""
            print(f"detect {tag} [{os.path.dirname(m3dssd_tpu_torch.__file__)}"
                  f"{', ' + form if form else ''}]: wall ms/call over "
                  f"{args.iters} calls: " + ", ".join(f"{x:.3f}" for x in v))
        return 0

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            detect(images, sfs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters

    kernels = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] = kernels.get(e.key, 0.0) + dev_us / 1e3
    busy_ms = sum(kernels.values()) / args.iters
    groups = {}
    for name, ms in kernels.items():
        g = group_of(name)
        groups[g] = groups.get(g, 0.0) + ms / args.iters

    print(f"card: {label}")
    print(f"detect {tag}: wall {wall_ms:.2f} ms/call under the profiler, "
          f"device busy {busy_ms:.2f} ms/call, idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}")
    print("device time by group (ms/call, share of busy):")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g:28s} {ms:9.3f}  {ms / busy_ms:.3f}")
    print(f"top {TOP} kernels (ms/call, share of busy):")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP]
    for name, ms in top:
        print(f"  {ms / args.iters:9.3f}  {ms / args.iters / busy_ms:.3f}  "
              f"{name[:110]}")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": label, "run": tag, "wall_ms": wall_ms,
                       "busy_ms": busy_ms, "groups": groups,
                       "top": {n: ms / args.iters for n, ms in top}},
                      f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

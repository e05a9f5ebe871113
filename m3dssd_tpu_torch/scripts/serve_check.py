"""Serving check, the port's counterpart of the reference package's
`scripts/serve_check.py`: export the detector (`inference/export.py`),
reload the artifact, run it and compare it with the live detector on the
same images, and time the served detector.

    python -m m3dssd_tpu_torch.scripts.serve_check [--flagship] \
        [--batch_size 8]

(DLA-34 at 192x640; with `--flagship` DLA-102 at 512x1760.)

Runs on the card unless given `--cpu`; on the card the artifact runs the
shift-DCN forward kernel through the custom op `m3dssd::dcn_shift`. The
last line of standard output is `{"serve_check": "ok" | "MISMATCH",
"latency_ms": ..., "max_abs_diff": ...}`; the exit code is 1 when the
served and live detections differ by 1e-3 or more. The served and the
eager detector's ms per call go to standard error.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

TOL = 1e-3


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m m3dssd_tpu_torch.scripts."
                                     "serve_check")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain ops) instead of the card")
    p.add_argument("--flagship", action="store_true",
                   help="DLA-102 at 512x1760 instead of the small DLA-34 at "
                        "192x640")
    p.add_argument("--batch_size", type=int, default=0)
    p.add_argument("--iters", type=int, default=20)
    return p.parse_args(argv)


def make_conf(flagship: bool = False):
    from ..config import flagship_conf

    if flagship:
        return flagship_conf((512, 1760))
    return flagship_conf((192, 640), num_scales=6, backbone="dla34")


def ms_per_call(fn, args, iters: int, device) -> float:
    """Mean ms of `iters` calls of fn(*args) after two warm calls, the
    card synchronised around them."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn(*args)
    fn(*args)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    sync()
    return (time.perf_counter() - t0) / iters * 1e3


def run_serve_check(conf, batch_size: int = 0, iters: int = 20,
                    device=None, log=None):
    """Export `conf`'s detector (random weights from seed 0) with
    `batch_size` (0: the single-image signature), reload it and compare it
    with the live detector on seeded float32 images. Returns {"serve_check",
    "latency_ms", "max_abs_diff", "eager_ms", "artifact_mb"}."""
    from ..anchors import locate_anchors
    from ..inference.detect import make_batch_detector, make_detector
    from ..inference.export import (export_detector, load_detector,
                                    save_exported)
    from ..models import build
    from ..utils.device import resolve_device

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    dev = resolve_device(device)
    model = build(conf, device=dev, seed=0)
    rois = locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    h, w = (int(s) for s in conf.test_scale)
    bs = batch_size
    log(f"[serve_check] device={dev} model={conf.back_bone} {h}x{w} "
        f"bs={bs or 1}")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "det.pt2")
        ep = export_detector(conf, rois, model, batch_size=bs, device=dev)
        save_exported(ep, path, conf=conf, batch_size=bs)
        size_mb = os.path.getsize(path) / 1e6
        served = load_detector(path, device=dev)

    gen = np.random.default_rng(0)
    img = torch.from_numpy(gen.normal(size=(bs or 1, h, w, 3))
                           .astype(np.float32)).to(dev)
    sf = torch.ones((bs,) if bs else (), dtype=torch.float32, device=dev)
    out_srv = served(img, sf)
    live = (make_batch_detector(conf, rois, model, device=dev) if bs
            else make_detector(conf, rois, model, device=dev))
    out_live = live(img, sf)
    diff = float((out_srv.double() - out_live.double()).abs().max())
    log(f"[serve_check] artifact {size_mb:.1f} MB; "
        f"max |served - live| = {diff:.3e}")

    n = bs or 1
    ms = ms_per_call(served, (img, sf), iters, dev)
    log(f"[serve_check] served latency {ms:.2f} ms/call "
        f"({n / ms * 1e3:.1f} im/s)")
    eager_ms = ms_per_call(live, (img, sf), iters, dev)
    log(f"[serve_check] eager latency {eager_ms:.2f} ms/call "
        f"({n / eager_ms * 1e3:.1f} im/s)")
    return {"serve_check": "ok" if diff < TOL else "MISMATCH",
            "latency_ms": ms, "max_abs_diff": diff, "eager_ms": eager_ms,
            "artifact_mb": size_mb}


def main(argv=None):
    args = parse_args(argv)
    from ..utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    res = run_serve_check(make_conf(args.flagship), args.batch_size,
                          args.iters, device)
    print(f'{{"serve_check": "{res["serve_check"]}", '
          f'"latency_ms": {res["latency_ms"]:.3f}, '
          f'"max_abs_diff": {res["max_abs_diff"]:.3e}}}', flush=True)
    if res["serve_check"] != "ok":
        sys.exit(1)


if __name__ == "__main__":
    main()

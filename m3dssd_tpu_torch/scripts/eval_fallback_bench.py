"""Timing of the pure-Python KITTI matching, the port's counterpart of the
reference package's `scripts/eval_fallback_bench.py`: the batched form
(`eval/kitti_eval.py:fused_statistics_py`, all 41 thresholds of an image
at once) against the per-threshold `compute_statistics` loop it replaced.

    python -m m3dssd_tpu_torch.scripts.eval_fallback_bench [n_images]

Host only (numpy), no card. `main()` turns the native C++ engine off for
its own process (M3DSSD_NO_NATIVE=1) before the engine is first loaded;
`run_eval_fallback_bench` refuses to run where the engine is loaded.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np


def synth_annos(n_images, seed=0):
    """(gt, dt) annotations of `n_images` images. Detections are jittered
    copies of the gts plus false positives, so the matcher sees realistic
    tp rates and the threshold grid fills to 41 (independent random boxes
    almost never reach IoU 0.7, and both forms would then skip the real
    work)."""
    rng = np.random.default_rng(seed)
    gt, dt = [], []
    names = np.array(["Car", "Pedestrian", "Cyclist"])

    def boxes(n):
        x = rng.uniform(0, 1100, n)
        y = rng.uniform(0, 300, n)
        w = rng.uniform(30, 120, n)
        h = rng.uniform(40, 130, n)
        return np.stack([x, y, x + w, y + h], axis=1)

    def annos(bbox, name):
        n = len(bbox)
        return {
            "name": name,
            "truncated": rng.uniform(0, 0.3, n),
            "occluded": rng.integers(0, 2, n).astype(np.int64),
            "alpha": rng.uniform(-np.pi, np.pi, n),
            "bbox": bbox,
            "dimensions": rng.uniform(1, 4, (n, 3)),
            "location": rng.uniform(-20, 60, (n, 3)),
            "rotation_y": rng.uniform(-np.pi, np.pi, n),
        }

    for _ in range(n_images):
        ng = int(rng.integers(3, 12))
        gb = boxes(ng)
        gname = rng.choice(names, ng)
        # ~85% of the gts detected (the small jitter keeps IoU > 0.7), plus
        # false positives
        det_mask = rng.uniform(size=ng) < 0.85
        db_tp = gb[det_mask] + rng.normal(0, 1.5, (int(det_mask.sum()), 4))
        nfp = int(rng.integers(5, 25))
        db = np.concatenate([db_tp, boxes(nfp)], axis=0)
        dname = np.concatenate([gname[det_mask], rng.choice(names, nfp)])
        g = annos(gb, gname)
        d = annos(db, dname)
        d["score"] = rng.uniform(0, 1, len(db))
        gt.append(g)
        dt.append(d)
    return gt, dt


def per_threshold(overlaps, gtd, dtd, ig, idt, dc, metric, min_overlap,
                  thresholds, compute_aos, pr):
    """The per-threshold form of `eval/kitti_eval.py:fused_statistics_py`:
    one whole matching per threshold per image."""
    from ..eval.kitti_eval import compute_statistics

    for t, thresh in enumerate(thresholds):
        tp, fp, fn, sim, _ = compute_statistics(
            overlaps, gtd, dtd, ig, idt, dc, metric,
            min_overlap=min_overlap, thresh=thresh,
            compute_fp=True, compute_aos=compute_aos)
        pr[t, 0] += tp
        pr[t, 1] += fp
        pr[t, 2] += fn
        if sim != -1:
            pr[t, 3] += sim


def run_eval_fallback_bench(n: int = 100, seed: int = 0):
    """`eval_class` over `synth_annos(n, seed)` (3 classes, 3
    difficulties, AOS) with the fused Python matcher, then with the
    per-threshold loop swapped in (and restored). Returns (fused seconds,
    loop seconds, fused result, loop result)."""
    from ..eval import kitti_eval as ke
    from ..eval import native

    if native.available():
        raise RuntimeError("the bench times the pure-Python engine, and the "
                           "native one is loaded: run it through main(), "
                           "which sets M3DSSD_NO_NATIVE first")
    gt, dt = synth_annos(n, seed)
    args = (gt, dt, [0, 1, 2], [0, 1, 2], 0)
    kw = dict(min_overlaps=ke.OVERLAP_0_7[None], compute_aos=True)

    t0 = time.perf_counter()
    fused_res = ke.eval_class(*args, **kw)
    fused = time.perf_counter() - t0

    orig = ke.fused_statistics_py
    ke.fused_statistics_py = per_threshold
    try:
        t0 = time.perf_counter()
        loop_res = ke.eval_class(*args, **kw)
        loop = time.perf_counter() - t0
    finally:
        ke.fused_statistics_py = orig
    return fused, loop, fused_res, loop_res


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    os.environ["M3DSSD_NO_NATIVE"] = "1"       # the Python engine
    n = int(argv[0]) if argv else 100
    fused, loop, a, b = run_eval_fallback_bench(n)
    same = all(np.array_equal(a[k], b[k], equal_nan=True) for k in a)
    print(f"python fallback over {n} images x 3 classes x AOS: "
          f"fused {fused:.2f}s vs per-threshold loop {loop:.2f}s "
          f"({loop / fused:.1f}x); AP tables "
          f"{'equal' if same else 'DIFFER'}", flush=True)
    if not same:
        sys.exit(1)


if __name__ == "__main__":
    main()

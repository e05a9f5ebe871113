"""The flagship's train trajectory on one fixed batch, as chip_smoke.py's
phase_train runs it, repeated from the same seed-0 weights:

    python3 profile_train_trajectory.py [--root DIR] [--runs 10] \
        [--save DIR --tag NAME]

384x1280 bs=8 bf16 packed input, the first batch of a TrainLoader over
the in-memory synthetic split (64 scenes of 375x1242, seed 7), the
smoke's FIXED_LR without warmup, FIXED_STEPS steps per run. Each run
builds the model from seed 0. Prints the card's name and power limit,
then one JSON line: the first step's loss and stats as float hex (bit for
bit), each run's losses, how many runs pass the smoke's falling-loss
check (the mean of the last 3 losses below the first), and each run's
parameters after its first step against the first run's (the largest
|diff| over the largest |update|, median per tensor of each one's own).

`--root` takes the port from another checkout (say the parent commit,
unpacked by `git archive` into an ignored directory), so two trees run
the same trajectory. With `--save`, the first run's parameters after its
first step go to DIR/NAME.pt and are held against every file saved there
before: run the trees in the order A B B A in one process list to see
the spread within a tree beside the gap between trees.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--save", default=None)
    ap.add_argument("--tag", default="run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_train_trajectory: no CUDA card")

    sys.path.insert(0, HERE)
    import chip_smoke as smoke

    # the port under test comes from --root, the smoke's settings from here
    sys.path.insert(0, os.path.abspath(args.root))
    from m3dssd_tpu_torch.data.loader import TrainLoader
    from m3dssd_tpu_torch.models import build
    from m3dssd_tpu_torch.ops import _build
    from m3dssd_tpu_torch.train.state import (create_train_state,
                                              make_train_step)

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(_build.__file__)))
    assert os.path.dirname(pkg) == os.path.abspath(args.root), \
        f"the port was imported from {pkg}"
    _build.build()
    B = smoke.TRAIN_BATCH
    conf = smoke.train_conf(smoke.TRAIN_CROP, B).replace(
        warmup=0.0, lr=smoke.FIXED_LR)
    ds = smoke.train_set(conf)
    batch = next(TrainLoader(ds, B, num_workers=8, seed=0,
                             pack_s2d=True).batches(1))

    runs, first_stats, stats_differ, after_first = [], None, [], []
    for r in range(args.runs):
        model = build(conf, seed=0, phase="train")
        if r == 0:
            init = {k: v.detach().cpu().clone()
                    for k, v in model.state_dict().items()}
            names = [n for n, _ in model.named_parameters()]
        state = create_train_state(conf, model, max_iter=10 ** 6)
        step = make_train_step(conf, ds.rois, packed_input=True)
        losses = []
        for i in range(smoke.FIXED_STEPS):
            stats = step(state, batch)
            losses.append(float(stats["loss"]))
            if i == 0:
                hexed = {k: float(v).hex() for k, v in stats.items()}
                if first_stats is None:
                    first_stats = hexed
                elif hexed != first_stats:
                    stats_differ.append(r)
                after = {k: v.detach().cpu().clone()
                         for k, v in model.state_dict().items()}
                if r == 0:
                    ref = after
                else:
                    after_first.append(smoke.update_errors(after, init, ref,
                                                           names))
                del after
        runs.append(losses)
        del model, state, step
        torch.cuda.empty_cache()

    vs_saved = {}
    if args.save:
        os.makedirs(args.save, exist_ok=True)
        for path in sorted(glob.glob(os.path.join(args.save, "*.pt"))):
            own, largest = smoke.update_errors(ref, init, torch.load(path),
                                               names)
            vals = sorted(own.values())
            vs_saved[os.path.basename(path)[:-3]] = {
                "update_median": vals[len(vals) // 2],
                "update_largest": largest}
        torch.save(ref, os.path.join(args.save, f"{args.tag}.pt"))

    def med(own):
        vals = sorted(own.values())
        return vals[len(vals) // 2]

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    print(json.dumps({
        "root": os.path.abspath(args.root), "tag": args.tag,
        "first_step_stats_hex": first_stats,
        "runs_with_other_first_stats": stats_differ,
        "falling_loss_passes": sum(sum(l[-3:]) / 3 < l[0] for l in runs),
        "runs": len(runs),
        "first_step_vs_run0": [{"update_median": med(own),
                                "update_largest": largest}
                               for own, largest in after_first],
        "first_step_vs_saved": vs_saved,
        "losses": runs}), flush=True)


if __name__ == "__main__":
    main()

"""AP-table trajectory over a run's per-epoch result directories, the
port's counterpart of the reference package's `scripts/eval_trajectory.py`.

The Trainer writes KITTI result txts under
`<run>/results/results_<epoch>/data` at every eval epoch; this recomputes
the AP table of each with the port's `eval/kitti_eval.py`, prints one JSON
row per epoch and then one `TRAJECTORY [...]` line.

    python -m m3dssd_tpu_torch.scripts.eval_trajectory --run output/exp \
        --gt ./data/kitti_split1/validation/label_2

The AP engine runs on the host; like the other entry points the CLI wants
the card unless `--cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import re


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m m3dssd_tpu_torch.scripts."
                                     "eval_trajectory")
    p.add_argument("--run", required=True, help="trainer output dir")
    p.add_argument("--gt", required=True, help="gt label_2 dir")
    p.add_argument("--metrics", nargs="*",
                   default=["Car_image_R40", "Car_bev_R40", "Car_3d_R40"],
                   help="grouped metric keys to tabulate ([easy, mod, hard])")
    p.add_argument("--cpu", action="store_true",
                   help="run without a card")
    return p.parse_args(argv)


def trajectory(run: str, gt: str, metrics):
    """[{"epoch": e, metric: [easy, mod, hard] rounded to 2 places}, ...]
    over the run's results_<epoch> directories, by epoch; each row is
    printed as it is computed."""
    from ..eval.kitti_eval import evaluate_kitti

    rdir = os.path.join(run, "results")
    epochs = sorted(
        (int(m.group(1)), os.path.join(rdir, d, "data"))
        for d in os.listdir(rdir)
        if (m := re.fullmatch(r"results_(\d+)", d))
        and os.path.isdir(os.path.join(rdir, d, "data")))
    rows = []
    for epoch, path in epochs:
        res = evaluate_kitti(gt, path)
        row = {"epoch": epoch}
        for k in metrics:
            if k in res:
                row[k] = [round(v, 2) for v in res[k]]
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None):
    from ..utils.device import resolve_device

    args = parse_args(argv)
    resolve_device("cpu" if args.cpu else None)
    rows = trajectory(args.run, args.gt, args.metrics)
    print("TRAJECTORY " + json.dumps(rows))


if __name__ == "__main__":
    main()

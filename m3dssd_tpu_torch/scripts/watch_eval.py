"""Eval watcher, the port's counterpart of the reference package's
`scripts/watch_eval.py`: polls a training run's checkpoint directory and
evaluates each new checkpoint as it appears, apart from the train
process.

    python -m m3dssd_tpu_torch.scripts.watch_eval --run_dir output/exp \
        --data_root ./data [--poll_sec 60] [--max_polls 0]

Each checkpoint `<run_dir>/weights/step_<N>` is restored into a model of
the run's conf.pkl and evaluated on the validation split through
`inference/test_driver.py:test_kitti_3d`, into
`<run_dir>/results/results_watch_<N>/data`; one line per checkpoint
gives its mean Car 3D AP-R40. `--max_polls 0` polls forever.
`--mesh_devices k` evaluates over k processes under torchrun, as the test
CLI does.
"""

from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m m3dssd_tpu_torch.scripts."
                                     "watch_eval")
    p.add_argument("--run_dir", required=True)
    p.add_argument("--data_root", required=True)
    p.add_argument("--poll_sec", type=float, default=60.0)
    p.add_argument("--max_polls", type=int, default=0, help="0 = forever")
    p.add_argument("--mesh_devices", type=int, default=0,
                   help="data-parallel eval over this many processes; run "
                        "under torchrun --nproc_per_node with the same "
                        "count")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain ops) instead of the card")
    return p.parse_args(argv)


def checkpoint_steps(ckpt_dir: str):
    """The steps of the checkpoints in `ckpt_dir`, in order."""
    from ..utils.checkpoint import latest_step

    if latest_step(ckpt_dir) is None:
        return []
    return sorted(int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
                  if n.startswith("step_") and n.split("_")[1].isdigit()
                  and os.path.exists(os.path.join(ckpt_dir, n, "state.pt")))


def watch(run_dir: str, data_root: str, poll_sec: float = 60.0,
          max_polls: int = 0, device=None, mesh=None):
    """Poll `<run_dir>/weights` `max_polls` times (0: forever), `poll_sec`
    apart, and evaluate every checkpoint not seen before on `data_root`'s
    validation split. Returns {step: selection metric}."""
    from ..anchors import locate_anchors
    from ..config import Config
    from ..data.kitti import Kitti3DDataset
    from ..inference.detect import (make_batch_detector, make_detector,
                                    packed_input_eligible)
    from ..inference.test_driver import test_kitti_3d
    from ..models import build
    from ..utils.checkpoint import load_model_weights

    conf = Config.load(os.path.join(run_dir, "conf.pkl"))
    model = build(conf, device=device, mesh=mesh)
    dataset = Kitti3DDataset(conf, data_root, phase="validation")
    gt_path = os.path.join(data_root, conf.datasets_validation[0]["name"],
                           "validation", "label_2")
    rois = locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    eval_bs = max(int(getattr(conf, "eval_batch_size", 1)), 1)
    packed = packed_input_eligible(conf)
    if eval_bs > 1:
        detect = make_batch_detector(conf, rois, model, packed_input=packed,
                                     device=device)
    else:
        detect = make_detector(conf, rois, model, packed_input=packed,
                               device=device)
    ckpt_dir = os.path.join(run_dir, "weights")
    seen = {}
    polls = 0
    while max_polls == 0 or polls < max_polls:
        for step in checkpoint_steps(ckpt_dir):
            if step in seen:
                continue
            load_model_weights(model, ckpt_dir, step)
            results = os.path.join(run_dir, "results",
                                   f"results_watch_{step}", "data")
            _, sel = test_kitti_3d(dataset, detect, conf, results,
                                   gt_path=gt_path if os.path.isdir(gt_path)
                                   else None, batch_size=eval_bs,
                                   packed_input=packed, mesh=mesh)
            seen[step] = sel
            if mesh is None or mesh.primary:
                print(f"step {step}: mean Car 3D R40 = {sel:.4f}",
                      flush=True)
        polls += 1
        if max_polls == 0 or polls < max_polls:
            time.sleep(poll_sec)
    return seen


def main(argv=None):
    args = parse_args(argv)
    device = "cpu" if args.cpu else None
    mesh = None
    if args.mesh_devices > 1:
        from ..parallel.mesh import init_distributed, make_mesh

        init_distributed(device=device)
        mesh = make_mesh(args.mesh_devices, device=device)
    watch(args.run_dir, args.data_root, poll_sec=args.poll_sec,
          max_polls=args.max_polls, device=device, mesh=mesh)


if __name__ == "__main__":
    main()

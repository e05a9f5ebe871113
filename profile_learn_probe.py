"""learn_probe's outcome over several model init seeds, on the card:

    python3 profile_learn_probe.py [--variants run2,plain] [--seeds 0,1,2]
        [--steps 1500] [--log_every 25] [--crop 384 1280] [--tf32 off]
        [--cpu]

For each variant and seed, `scripts/learn_probe.py:run_variant` trains a
model built from that seed on learn_probe's fixed batches (the first 16
images, bs=4, of convergence_check's in-memory split at the crop). A
single run's verdict says little: which step the classifier leaves the
all-background state depends on the init. So this prints, per run, the
first printed step with acc_fg > 0.5 (the escape; null if none), the last
step's acc_fg, loss and err_z, the count of steps with a non-finite stat,
the largest |weight| of the DCN offset convs at the end (the learned
offsets of the gather DCN are unbounded) and the steps per second, after
the card's name and power limit, and ends with one JSON line of them all.
`--tf32 off` turns TF32 off for convolutions too (a fresh process has it
on for cuDNN convolutions and off for matmuls, torch's defaults).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--variants", default="run2,plain")
    p.add_argument("--seeds", default="0,1,2")
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--log_every", type=int, default=25)
    p.add_argument("--images", type=int, default=16)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--crop", type=int, nargs=2, default=[384, 1280])
    p.add_argument("--tf32", choices=("default", "off"), default="default")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    import torch

    if args.tf32 == "off":
        torch.backends.cudnn.allow_tf32 = False

    from m3dssd_tpu_torch.scripts import convergence_check as cc
    from m3dssd_tpu_torch.scripts import learn_probe as lp
    from m3dssd_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cpu" if args.cpu else None)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    conf = lp.make_conf(args.batch_size, "dla34", args.crop)
    base, ds, fixed = lp.probe_data(
        conf, cc.in_memory_train_set(lp.no_aug(conf)), args.images)
    runs = []
    for name in args.variants.split(","):
        for seed in map(int, args.seeds.split(",")):
            res = lp.run_variant(base, name, fixed, ds.rois, args.steps,
                                 args.log_every, dev, out=lambda s: None,
                                 seed=seed)
            escape = next((s for s, st in res["logged"]
                           if st["acc_fg"] > 0.5), None)
            st = res["stats"]
            offw = max(float(t.detach().abs().max()) for n, t in
                       res["state"].model.named_parameters()
                       if "conv_offset_mask" in n)
            run = {"variant": name, "seed": seed, "escape_step": escape,
                   "verdict": res["verdict"], "acc_fg": st["acc_fg"],
                   "loss": st["loss"], "err_z": st["err_z"],
                   "nonfinite_steps": res["nonfinite_steps"],
                   "offset_w_max": offw,
                   "steps_per_s": res["steps_per_s"]}
            runs.append(run)
            print(json.dumps(run), flush=True)
    print(json.dumps({"device": str(dev), "steps": args.steps,
                      "crop": args.crop, "tf32": args.tf32, "runs": runs}),
          flush=True)


if __name__ == "__main__":
    sys.exit(main())

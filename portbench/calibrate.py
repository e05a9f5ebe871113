"""Readings from which a cell's limits are set: the program's compared
numbers over many seeds and the control's (the reference in float8, put in
the program's place), in one process.

    python3 -m portbench.calibrate --workload NAME --seeds 1,2,3 \
        [--calls 8] [--control] [--fault NAME]

For each seed it sets the cell up as a run does (weights, inputs, the
program's detector), makes `--calls` calls at the cell's load, keeps the
run's sample of them, frees the program and prints one JSON line:
{"seed", "program": {number: reading}, "control": {...}, "diagnostics"}.
With `--fault` the program runs with that fault of `faults.py` planted,
and its readings are the fault's. The benchmark's own runs never run the
control or a fault.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
import time

import torch

from portbench import faults, spec


def readings(cell, seed, calls, control, device="cuda", fault=None):
    module = importlib.import_module("portbench.entries."
                                     + cell.traffic["entry"])
    with faults.FAULTS[fault]() if fault else contextlib.nullcontext():
        entry = module.Entry(cell, seed, device)
        for i in range(calls):
            entry.call(i)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        entry.close()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"seed": seed}
    out["program"], out["diagnostics"] = entry.readings()
    if control:
        out["control"], _ = entry.readings(control=True)
    del entry
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--calls", type=int, default=8)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: CUDA is not available", file=sys.stderr)
        return 3
    cell = spec.Cell(spec.load_bench(), args.workload)
    # as in a run: the set-up's host threads change the weights' last bits
    torch.set_num_threads(1)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = readings(cell, seed, args.calls, args.control,
                       fault=args.fault)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

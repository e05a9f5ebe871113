"""Time the shift-DCN backward kernels on one CUDA card.

    python3 profile_bwd.py [--root DIR] [--rounds N] [--parts]

Builds and imports the port found under DIR (default: the checkout beside
this file), then times each backward kernel (cols, data, coord) by CUDA
events at the 8 neck shapes of a 384x1280 bs=8 train step in bfloat16,
clamp 1.0, with 30% of the offsets on a kink (the inputs of
`chip_smoke.py`'s `phase_bwd_vs_plain`), and prints each kernel's ms, its
bound (`chip_smoke.bwd_bounds`) and share of bound per shape and summed
over the 8 layers, the registers and spills nvcc reported, and the card's
name and power limit. With --parts it also times two altered copies of the
coord kernel, built under the git-ignored `_build/parts/` of DIR's
package: one that only stages its chunks (the TMA copies and barriers, no
arithmetic) and one that only computes (no copies: the arithmetic on
whatever shared memory holds), to show which of the two bounds it. To
compare two trees, unpack the other one (`git archive`) into a git-ignored
directory and run this script on each in one call, in turns (A, B, B, A).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# edits of csrc/dcn_shift_bwd.cu for --parts: (name, [(old, new), ...])
PARTS = [
    ("loads only", [("#pragma unroll\n    for (int v = 0; v < RV; ++v) {",
                     "    if (a.C < 0)\n#pragma unroll\n"
                     "    for (int v = 0; v < RV; ++v) {")]),
    ("compute only", [
        ("    coord_issue<CH, SLAB, BYTES>(smem, full, xm, gm, t, a.H, P, j0);",
         ""),
        ("    if (tid == 0 && j + 1 < j1)\n      coord_issue",
         "    if (a.C < 0)\n      coord_issue"),
        ("    mbar_wait(&full[(j - j0) & 1], ((j - j0) >> 1) & 1);", "")]),
]


def part_tree(root, name, edits):
    """A copy of root's package with the coord kernel edited; returns its
    root."""
    pkg = os.path.join(root, "m3dssd_tpu_torch")
    dst = os.path.join(pkg, "_build", "parts", name.replace(" ", "_"))
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(pkg, os.path.join(dst, "m3dssd_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build"))
    src = os.path.join(dst, "m3dssd_tpu_torch", "csrc", "dcn_shift_bwd.cu")
    with open(src) as f:
        text = f.read()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"--parts: {name}: the coord kernel changed; "
                               f"no {old!r}")
        text = text.replace(old, new)
    with open(src, "w") as f:
        f.write(text)
    return dst


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--parts", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_bwd: no CUDA card", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.path.insert(1, HERE)
    import chip_smoke as cs
    from m3dssd_tpu_torch.ops import _build
    from m3dssd_tpu_torch.ops import dcn_cuda as dc

    print(cs.card_label())
    built = _build.build(["dcn_shift_bwd"])
    for line in cs.ptxas_summary(built["dcn_shift_bwd"][1]):
        print(f"  {line}")
    dev = torch.device("cuda")
    dtype = torch.bfloat16
    sums = {k: {"ms": 0.0, "bound_ms": 0.0} for k in cs.BWD_KERNELS}
    rows = []
    for i, s in enumerate(cs.NECK_SHAPES_384):
        B, (H, W, C, Co) = 8, s
        x, off, mask, w, g = cs.bwd_inputs(B, H, W, C, Co, dtype, dev,
                                           seed=100 + i, clamp=1.0)
        gk = torch.matmul(g.reshape(-1, Co), w.reshape(-1, Co).t())
        runs = {
            "cols": lambda: dc.dcn_shift_bwd_cols_cuda(x, off, mask),
            "data": lambda: dc.dcn_shift_bwd_data_cuda(gk, off, mask,
                                                       x.shape),
            "coord": lambda: dc.dcn_shift_bwd_coord_cuda(x, gk, off, mask),
        }
        bounds = cs.bwd_bounds(B, H, W, C, Co, dtype, off, 1.0)
        row = {"shape": [B, H, W, C, Co]}
        for k, fn in runs.items():
            ms = cs.cuda_ms(fn, args.rounds, warmup=2)
            bound = max(bounds[k])
            row[k] = {"ms": ms, "bound_ms": bound, "share": bound / ms}
            sums[k]["ms"] += ms
            sums[k]["bound_ms"] += bound
        rows.append(row)
        print(f"  {B},{H},{W},{C}->{Co}: " + "; ".join(
            f"{k} {row[k]['ms']:.4f} ms (bound {row[k]['bound_ms']:.4f}, "
            f"{row[k]['share']:.3f})" for k in runs))
        del x, off, mask, w, g, gk
    for k, t in sums.items():
        print(f"  8 layers, {k}: {t['ms']:.4f} ms, bound {t['bound_ms']:.4f} "
              f"ms, share {t['bound_ms'] / t['ms']:.4f}")
    parts = {}
    if args.parts:
        for name, edits in PARTS:
            tree = part_tree(root, name, edits)
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--root", tree,
                 "--rounds", str(args.rounds)],
                capture_output=True, text=True, timeout=600)
            if res.returncode != 0:
                print(res.stdout[-2000:], res.stderr[-2000:])
                return 1
            parts[name] = json.loads(res.stdout.splitlines()[-1])["sums"][
                "coord"]
            print(f"  8 layers, coord {name}: {parts[name]['ms']:.4f} ms")
    print(json.dumps({"root": root, "shapes": rows, "sums": sums,
                      "coord_parts": parts}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

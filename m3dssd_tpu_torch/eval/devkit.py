"""The devkit-protocol oracle: the repository's `native/devkit_eval.cpp`.

An implementation of the official KITTI devkit protocol written apart from
`kitti_eval.py` and `native/m3deval.cpp` (its own parser, polygon clipper
and matching loop), so agreeing with it checks the AP engine against code
that is not the same derivation. Built with g++ into `_build/` at first
use (`eval/native.py:build`) and run as a subprocess.
"""

from __future__ import annotations

import subprocess
from typing import Dict, List, Optional

from .native import build

CXX_FLAGS = ["-O3", "-std=c++17", "-Wall"]


def _binary() -> Optional[str]:
    return build("devkit_eval.cpp", CXX_FLAGS, "devkit_eval")


def available() -> bool:
    return _binary() is not None


def evaluate(gt_dir: str, dt_dir: str) -> Dict[str, List[float]]:
    """Run the oracle on a gt and a detection folder of KITTI txts.
    Returns {'<Class>_<metric>': [easy, moderate, hard]} for metric in
    image, ground, box3d and aos, AP11 under that key and AP-R40 under
    '<key>_R40' (the keys of `kitti_eval.evaluate_kitti`, with 'ground'
    and 'box3d' for 'bev' and '3d')."""
    binary = _binary()
    if binary is None:
        raise RuntimeError("devkit oracle unavailable: g++ could not build "
                           "native/devkit_eval.cpp")
    proc = subprocess.run([binary, gt_dir, dt_dir], check=True,
                          capture_output=True, text=True)
    out: Dict[str, List[float]] = {}
    for line in proc.stdout.splitlines():
        parts = line.split()
        if len(parts) != 8:
            continue
        cname, metric = parts[0], parts[1]
        vals = [float(v) for v in parts[2:]]
        out[f"{cname}_{metric}"] = vals[0:3]
        out[f"{cname}_{metric}_R40"] = vals[3:6]
    return out

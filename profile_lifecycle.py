"""The run lifecycle's seconds on one CUDA card, per backbone.

    python3 profile_lifecycle.py [BACKBONE ...]

Runs `chip_smoke.py`'s `phase_run_lifecycle` (train CLI epoch, test CLI
from the snapshot in a fresh process, export in both align regimes, every
check of the phase) once for each backbone named, in that order (default
dla102 dla60 dla60 dla102: each side first once), and prints each run's
seconds. The first run also builds the kernels' libraries and the
synthetic train split. Prints the card's name and power limit.
"""

from __future__ import annotations

import os
import sys
import time

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_lifecycle: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from m3dssd_tpu_torch.ops import _build

    backbones = sys.argv[1:] or ["dla102", "dla60", "dla60", "dla102"]
    _build.build()
    label = cs.card_label()
    print(label, flush=True)
    runs = []
    for name in backbones:
        cs.LIFE_BACKBONE = name
        t0 = time.perf_counter()
        cs.phase_run_lifecycle(label)
        runs.append((name, time.perf_counter() - t0))
        print(f"lifecycle on {name}: {runs[-1][1]:.1f} s", flush=True)
    print("seconds per run: " + ", ".join(f"{n} {s:.1f}" for n, s in runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Logging and stat tracking.

The loss returns named scalars (device tensors), a tracker accumulates them
between display intervals and `flush` logs their means, reading them to
the host only then (one sync per interval, not per step). A writer with
`add_scalar` (tensorboard's) is optional; the port runs without one.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from collections import defaultdict
from typing import Dict, Optional


def init_logging(log_file: Optional[str] = None, level=logging.INFO):
    """Logging to stdout and, when given, a file."""
    handlers = [logging.StreamHandler(sys.stdout)]
    if log_file:
        os.makedirs(os.path.dirname(log_file), exist_ok=True)
        handlers.append(logging.FileHandler(log_file))
    logging.basicConfig(
        level=level, handlers=handlers, force=True,
        format="%(asctime)s %(levelname)s %(message)s", datefmt="%H:%M:%S")


def pretty_print(name: str, d: Dict, val_width: int = 60) -> str:
    """Aligned 'name.key: value' dump of a config dict for the run log.
    Long values are truncated, numpy arrays are summarised by shape."""
    import numpy as np

    rows = []
    key_w = max((len(k) for k in d), default=0)
    for k in sorted(d):
        v = d[k]
        if isinstance(v, np.ndarray):
            s = f"ndarray{v.shape} dtype={v.dtype}"
        else:
            s = repr(v)
        if len(s) > val_width:
            s = s[:val_width - 3] + "..."
        rows.append(f"{name}.{k:<{key_w}} : {s}")
    bar = "-" * (len(name) + key_w + val_width + 4)
    return "\n".join([bar] + rows + [bar])


def compute_eta(start_time, idx, total):
    """(ETA string, seconds per iteration)."""
    dt = (time.time() - start_time) / max(idx, 1)
    remaining = dt * (total - idx)
    h, rem = divmod(int(remaining), 3600)
    m, s = divmod(rem, 60)
    return f"{h}h{m}m{s}s", dt


class StatTracker:
    """Accumulate named scalars; flush means every display interval."""

    def __init__(self, writer=None, prefix: str = "Train"):
        # raw (possibly device) values; float() waits for flush, since
        # reading a step's stats every iteration would block on that step
        self.vals: Dict[str, list] = defaultdict(list)
        self.counts: Dict[str, int] = defaultdict(int)
        self.writer = writer
        self.prefix = prefix

    def update(self, stats: Dict[str, float]):
        for k, v in stats.items():
            self.vals[k].append(v)
            self.counts[k] += 1

    def means(self) -> Dict[str, float]:
        return {k: float(sum(float(v) for v in vs)) / max(len(vs), 1)
                for k, vs in self.vals.items()}

    def flush(self, step: int, extra: str = "") -> str:
        means = self.means()
        parts = [f"{k}={v:.4f}" for k, v in sorted(means.items())]
        msg = f"step {step} {extra} " + ", ".join(parts)
        logging.info(msg)
        if self.writer is not None:
            for k, v in means.items():
                self.writer.add_scalar(f"{self.prefix}/{k}", v, step)
        self.vals.clear()
        self.counts.clear()
        return msg

"""Tracing and profiling helpers: a per-phase wall-clock timer, a
`torch.profiler` trace of the host and the card, and the TensorBoard scalar
writer the Trainer logs to."""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Dict

import torch


class PhaseTimer:
    """Accumulate wall-clock seconds per named phase."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def means(self) -> Dict[str, float]:
        return {k: self.totals[k] / max(self.counts[k], 1)
                for k in self.totals}

    def report(self) -> str:
        return ", ".join(f"{k}={v * 1000:.2f}ms" for k, v in
                         sorted(self.means().items()))


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the block with `torch.profiler` (CPU activity, and the card's
    when CUDA is available) and write a Chrome / Perfetto trace under
    `log_dir`. Yields the profiler, whose `key_averages()` can be read
    after the block."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    logging.info("profiler trace written to %s", path)


def make_tb_writer(log_dir: str):
    """A TensorBoard `SummaryWriter` on `log_dir`, or None (with a warning)
    when `torch.utils.tensorboard` cannot be imported or opened."""
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter(log_dir)
    except Exception:  # noqa: BLE001
        logging.warning("tensorboard writer unavailable")
        return None

"""Tracing and profiling: program spans and counts, a `torch.profiler`
trace of the host and the card, and the TensorBoard scalar writer the
Trainer logs to.

Spans mark where the program's own work starts and ends. `span(name)` is a
`torch.profiler.record_function` range while a profiler records and one
shared no-op context otherwise, so it costs a flag check when nothing
traces. The ranges land in the profiler's trace beside the kernels, on the
same clock: a kernel belongs to the span its launch ran in, an idle gap of
the card to the span the host was in, and nesting on the host thread gives
each span its parent. Every name takes the prefix `m3dssd.`.

`counts` is the process's one registry of counts (`count(name, n)`), kept
whether or not a profiler runs: host syncs (`sync.<site>`), dense
fallbacks of a sparse path (`fallback.<site>`) and kernel launches
(`dcn_shift.fwd`, `dcn_shift.bwd.cols`, `.data`, `.coord`, `nms.kernel`).
A reader takes differences, or sets a name back to 0 before the work it
counts.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import Counter

import torch
import torch.autograd.profiler as _autograd_profiler

counts: Counter = Counter()
_NO_SPAN = contextlib.nullcontext()


def count(name: str, n: int = 1) -> None:
    """Add n to the count `name`."""
    counts[name] += n


def span(name: str):
    """A `record_function(name)` range while a profiler records, else the
    shared no-op context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)


def host_sync(site: str):
    """Count a host sync at `site` (`sync.<site>`) and return its span,
    `m3dssd.sync.<site>`, to hold around the statement that waits."""
    count("sync." + site)
    return span("m3dssd.sync." + site)


def read_back(site: str, t) -> bool:
    """`bool(t)` of a one-element device tensor, read back inside the span
    `m3dssd.sync.<site>` and counted as `sync.<site>`: the one way the
    detect path reads a device value."""
    with host_sync(site):
        return bool(t)


def fallback(site: str):
    """Count the dense fallback of a sparse path at `site`
    (`fallback.<site>`) and return its span, `m3dssd.fallback.<site>`."""
    count("fallback." + site)
    return span("m3dssd.fallback." + site)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the block with `torch.profiler` (CPU activity, and the card's
    when CUDA is available) and write a Chrome / Perfetto trace under
    `log_dir`. Yields the profiler, whose `key_averages()` can be read
    after the block; the program's spans are in both."""
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

"""From a `torch.profiler` trace of a stretch of calls to what the per-layer
metrics read: the device's busy time and the stretch's length, device time
by kernel, device time of the kernels launched inside named ranges, and the
idle gaps with what the host was doing in each.

Ranges are `record_function` spans that global module hooks open around
the forward of modules of a named class, so nothing is put into the
program. A kernel belongs to a range when the host call that launched it
(same correlation id) started inside the range on the same thread.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

from .groups import group_of

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
# host events looked back over for the one running in an idle gap
SCAN = 2000


class RangeHooks:
    """Open a `record_function` range named `name` around the forward of
    every module whose class is one of `classes`, for {name: classes}."""

    def __init__(self, ranges: Dict[str, List[str]]):
        self.by_cls = {cls: name for name, classes in ranges.items()
                       for cls in classes}
        self.open: List[object] = []
        self.handles = []

    def _pre(self, mod, args):
        name = self.by_cls.get(type(mod).__name__)
        if name is not None:
            rf = torch.autograd.profiler.record_function(name)
            rf.__enter__()
            self.open.append(rf)

    def _post(self, mod, args, out):
        if type(mod).__name__ in self.by_cls and self.open:
            self.open.pop().__exit__(None, None, None)

    def __enter__(self):
        reg = torch.nn.modules.module
        self.handles = [reg.register_module_forward_pre_hook(self._pre),
                        reg.register_module_forward_hook(self._post)]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        self.handles = []


def events_of(prof) -> List[dict]:
    """The complete ("X") events of a finished profile."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    return [e for e in data.get("traceEvents", []) if e.get("ph") == "X"]


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """Reduction of the events of one traced stretch (times in s)."""

    def __init__(self, events: List[dict]):
        dev = [e for e in events if e.get("cat") in DEVICE_CATS]
        self.device = [(e["name"], float(e["ts"]) * 1e-6,
                        float(e.get("dur", 0.0)) * 1e-6,
                        (e.get("args") or {}).get("correlation"))
                       for e in dev]
        host = [e for e in events if e.get("cat") in HOST_CATS]
        self.launch = {}
        for e in host:
            c = (e.get("args") or {}).get("correlation")
            if c is not None and e.get("cat") in ("cuda_runtime",
                                                  "cuda_driver"):
                self.launch[c] = (float(e["ts"]) * 1e-6, e.get("tid"))
        self.ranges = defaultdict(list)
        for e in host:
            if e.get("cat") == "user_annotation":
                s = float(e["ts"]) * 1e-6
                self.ranges[e["name"]].append(
                    (s, s + float(e.get("dur", 0.0)) * 1e-6, e.get("tid")))
        self.host = sorted(
            (float(e["ts"]) * 1e-6, float(e.get("dur", 0.0)) * 1e-6,
             e["name"]) for e in host)
        busy = _merge([(t, t + d) for _, t, d, _ in self.device])
        self.busy_s = sum(e - s for s, e in busy)
        self.window_s = (busy[-1][1] - busy[0][0]) if busy else 0.0
        self._busy = busy

    def kernel_seconds(self) -> Dict[str, float]:
        out = defaultdict(float)
        for name, _, d, _ in self.device:
            out[name] += d
        return dict(out)

    def range_seconds(self, name: str):
        """Device seconds of the kernels launched inside range `name`, or
        None when the stretch has no such range."""
        spans = self.ranges.get(name)
        if not spans:
            return None
        by_tid = defaultdict(list)
        for s, e, tid in spans:
            by_tid[tid].append((s, e))
        # nested or repeated ranges of one name count once
        spans = sorted((s, e, tid) for tid, iv in by_tid.items()
                       for s, e in _merge(iv))
        starts = [s for s, _, _ in spans]
        total = 0.0
        for _, _, d, corr in self.device:
            if corr not in self.launch:
                continue
            t, tid = self.launch[corr]
            i = bisect.bisect_right(starts, t) - 1
            while i >= 0 and spans[i][2] != tid:
                i -= 1
            if i >= 0 and t <= spans[i][1]:
                total += d
        return total

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Idle seconds between device work, summed by the innermost host
        event running at each gap's middle."""
        by = defaultdict(float)
        starts = [t for t, _, _ in self.host]
        for (_, e0), (s1, _) in zip(self._busy, self._busy[1:]):
            gap = s1 - e0
            if gap <= 0:
                continue
            mid = e0 + gap / 2
            best = None
            i = bisect.bisect_right(starts, mid) - 1
            for t, d, name in self.host[max(i - SCAN, 0):i + 1]:
                if t + d >= mid and (best is None or d < best[0]):
                    best = (d, name)
            by[best[1] if best else "(no host event)"] += gap
        return sorted(by.items(), key=lambda kv: -kv[1])

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernel_seconds().items(), key=lambda kv: -kv[1])
        return {"device_ops": [[f"{group_of(n)} | {n[:160]}", s]
                               for n, s in ops[:top]],
                "idle_gaps": [[n[:160], s]
                              for n, s in self.idle_gaps()[:top]]}

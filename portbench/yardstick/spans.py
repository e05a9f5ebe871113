"""Readings of the program's own profiler spans in a traced stretch.

The port opens `record_function` spans named `m3dssd.*` at its layer
boundaries while a profiler records (m3dssd_tpu_torch/utils/profiling.py):
`m3dssd.detect` around each detect call, `m3dssd.decode`, `m3dssd.nms`,
one `m3dssd.nms.round` a round, `m3dssd.align.*`, `m3dssd.anab`, one
`m3dssd.sync.<site>` a host read-back and one `m3dssd.fallback.<site>` a
dense fallback. A program without them (no `m3dssd.detect` in the trace)
reads None everywhere, so a metric of them is left out of its line.
"""

from __future__ import annotations

DETECT = "m3dssd.detect"


def traced(run) -> bool:
    """True when the stretch holds the program's detect spans."""
    return bool(run.trace.ranges.get(DETECT)) and run.calls > 0


def named(run, prefix: str):
    """The span names in the stretch that start with `prefix`."""
    return sorted(n for n in run.trace.ranges if n.startswith(prefix))


def device_ms(run, names):
    """Device ms a call of the kernels launched inside the spans `names`,
    or None when the program has no spans or none of these."""
    if not traced(run):
        return None
    secs = [run.trace.range_seconds(n) for n in names]
    secs = [s for s in secs if s is not None]
    return sum(secs) * 1e3 / run.calls if secs else None


def spans_per_call(run, prefix: str):
    """Spans a call whose name starts with `prefix` (0 when none ran), or
    None when the program has no spans."""
    if not traced(run):
        return None
    n = sum(len(run.trace.ranges[name]) for name in named(run, prefix))
    return n / run.calls


def _busy(device):
    out = []
    for s, e in sorted((t, t + d) for _, t, d, _ in device):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def drained_idle_ms(run, prefix: str):
    """Idle ms a call of the card's gaps that begin while the host waits
    inside a span whose name starts with `prefix` and last past the span's
    end: the card ran dry during the wait and stayed idle until the host's
    next launch reached it. A gap that ends inside the span is a bubble
    between kernels already queued, not the wait's. None when the program
    has no spans."""
    if not traced(run):
        return None
    spans = sorted((s, e) for name in named(run, prefix)
                   for s, e, _ in run.trace.ranges[name])
    busy = _busy(run.trace.device)
    total, i = 0.0, 0
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        while i < len(spans) and spans[i][1] < e0:
            i += 1
        # spans of one thread do not overlap: the first that ends at or
        # after e0 is the only one that can hold it
        if i < len(spans) and spans[i][0] <= e0 and s1 > spans[i][1]:
            total += s1 - e0
    return total * 1e3 / run.calls

"""The eight readers of the program's own spans (`yardstick/spans.py`) on
synthetic traces: device time in spans, spans a call, idle time after a
sync; None on a program without the spans; and a traced run on the CPU
that reports them."""

import pytest

from portbench import run
from portbench.yardstick.trace import Trace

SPAN_METRICS = ("detect.decode_ms", "detect.nms_ms", "detect.nms_rounds",
                "detect.align_ms", "detect.anab_ms", "detect.host_syncs",
                "detect.sync_idle_ms", "detect.dense_fallbacks")


class Events:
    """A Chrome trace built by hand (times in us): host spans, and kernels
    with the launch that issued them."""

    def __init__(self):
        self.events = []
        self.corr = 0

    def span(self, name, s, e, tid=1):
        self.events.append({"ph": "X", "cat": "user_annotation",
                            "name": name, "ts": s, "dur": e - s,
                            "tid": tid})

    def kernel(self, launch, start, dur, tid=1):
        self.corr += 1
        self.events.append({"ph": "X", "cat": "cuda_runtime",
                            "name": "cudaLaunchKernel", "ts": launch,
                            "dur": 1, "tid": tid,
                            "args": {"correlation": self.corr}})
        self.events.append({"ph": "X", "cat": "kernel",
                            "name": f"k{self.corr}", "ts": start,
                            "dur": dur, "tid": 7,
                            "args": {"correlation": self.corr}})


def _call(ev, o, fallback=False):
    """One detect call at offset o. Device time a call: select 5, shape
    10 + 6 + 7 (+7 in its fallback), anab 20, decode 30, nms 4 + 3 rounds
    of 8; two syncs, after which the card runs dry for 31 and 40 us."""
    ev.span("m3dssd.detect", o, o + 900)
    ev.span("m3dssd.head", o + 5, o + 160)
    ev.span("m3dssd.align.select", o + 10, o + 20)
    ev.kernel(o + 15, o + 16, 5)
    ev.span("m3dssd.align.shape", o + 20, o + 100)
    ev.kernel(o + 30, o + 31, 10)                     # busy to o + 41
    # queued before the sync: a bubble o + 41 .. 44 while the host waits
    ev.kernel(o + 32, o + 44, 6)
    ev.span("m3dssd.sync.align.shape", o + 35, o + 60)
    ev.kernel(o + 79, o + 81, 7)                      # dry o + 50 .. 81
    if fallback:
        ev.span("m3dssd.fallback.align.shape", o + 61, o + 95)
        ev.kernel(o + 90, o + 95, 7)
    ev.span("m3dssd.anab", o + 100, o + 150)
    ev.kernel(o + 120, o + 121, 20)
    ev.span("m3dssd.decode_nms", o + 200, o + 800)
    ev.span("m3dssd.decode", o + 200, o + 250)
    ev.kernel(o + 210, o + 211, 30)                   # busy to o + 241
    ev.span("m3dssd.nms", o + 250, o + 700)
    ev.kernel(o + 251, o + 252, 4)                    # busy to o + 256
    ev.span("m3dssd.sync.nms.neg_inf", o + 253, o + 270)
    for k in range(3):
        s = o + 280 + 50 * k
        ev.span("m3dssd.nms.round", s, s + 50)
        # the first round's kernel ends the sync's gap: o + 256 .. 296
        ev.kernel(s + 15, s + 16, 8)


def _run(events, calls):
    return run.TraceRun(Trace(events), calls, 1.0, object())


def _read(cells, name, trace_run):
    return cells["detect.fullalign.b64"].reader(name).read(trace_run)


def test_span_readers_on_a_synthetic_trace(cells):
    ev = Events()
    _call(ev, 0)
    _call(ev, 1000, fallback=True)
    r = _run(ev.events, 2)
    got = {m: _read(cells, m, r) for m in SPAN_METRICS}
    # us a call -> ms: the fallback's kernel counts in one call of two
    assert got["detect.align_ms"] == pytest.approx(
        (5 + 10 + 6 + 7 + 3.5) * 1e-3)
    assert got["detect.anab_ms"] == pytest.approx(20e-3)
    assert got["detect.decode_ms"] == pytest.approx(30e-3)
    assert got["detect.nms_ms"] == pytest.approx((4 + 3 * 8) * 1e-3)
    assert got["detect.nms_rounds"] == 3
    assert got["detect.host_syncs"] == 2
    assert got["detect.dense_fallbacks"] == 0.5
    # gaps that begin in a sync span and outlast it: 31 + 40 us a call;
    # the bubble inside the sync and the gaps between the select, shape
    # and ANAB kernels do not count
    assert got["detect.sync_idle_ms"] == pytest.approx(71e-3)


def test_span_readers_read_none_without_the_program_spans(cells):
    """The harness's own ranges (the parent's program has no spans)."""
    ev = Events()
    ev.span("M3DRPN", 0, 500)
    ev.span("base", 0, 200)
    ev.kernel(10, 11, 50)
    ev.span("decode_nms", 600, 800)
    ev.kernel(610, 611, 30)
    r = _run(ev.events, 1)
    assert all(_read(cells, m, r) is None for m in SPAN_METRICS)
    assert cells["detect.fullalign.b64"].reader(
        "detect.decode_nms_ms").read(r) == pytest.approx(30e-3)


def test_span_readers_count_zero_where_the_program_ran_none(cells):
    ev = Events()
    ev.span("m3dssd.detect", 0, 100)
    ev.kernel(10, 11, 50)
    r = _run(ev.events, 1)
    assert _read(cells, "detect.dense_fallbacks", r) == 0
    assert _read(cells, "detect.host_syncs", r) == 0
    assert _read(cells, "detect.sync_idle_ms", r) == 0
    assert _read(cells, "detect.anab_ms", r) is None


@pytest.mark.parametrize("name", ["detect.fullalign.b64", "detect.base.b64"])
def test_traced_cpu_run_reports_the_span_metrics(tiny_cells, name):
    cell = tiny_cells[name]
    res = run.run_cell(cell, 2 ** 31 + 77, 0.2, 1, device="cpu")
    want = {m["name"] for m in cell.per_layer()} & set(SPAN_METRICS)
    assert len(want) == (8 if "fullalign" in name else 6)
    assert want <= set(res["metrics"])
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["detect.nms_rounds"] == 40
    assert m["detect.dense_fallbacks"] == 0
    # the align read-backs and the NMS's -inf scalar, or the scalar alone
    assert m["detect.host_syncs"] == (4 if "fullalign" in name else 1)

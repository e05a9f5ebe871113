"""Run one cell of the port's benchmark and print its result line.

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout that holds BENCHMARK.json, portbench/ and the
port (m3dssd_tpu_torch). Set-up (imports, the card, weights, the cell's
warm-up and, in a fresh checkout, the port's nvcc build) is timed from the
process's start to the first timed call, less the seconds of the
reference's own work in it (FLOP counts, weight calibration). The window
then issues calls back to back for S seconds; each call's latency runs
from its issue on the host to a CUDA event recorded after it, read once
the window has closed. With
`--trace 1` a stretch of `trace_calls` more calls runs under the profiler
after the window, and the cell's per-layer metrics are read from it (rates
from the untraced window). Then the program is freed and a sample of the
window's calls, drawn from the seed, is compared with the plain reference:
each compared number and its limit go to standard error and under
"checks", the last key of the result line.

Without CUDA, with fewer cards than the cell asks for, or with JAX or the
JAX package loaded once the window has closed, it prints no result and
exits non-zero.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# kernel caches at fixed paths inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(ROOT, ".portbench_cache", _sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "m3dssd_tpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def percentile(values, q):
    """The q-th percentile with linear interpolation between ranks."""
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


class Window:
    """Completion times of calls relative to the window's start: CUDA
    events on the card, the host clock on the CPU (tests)."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []
        if self.cuda:
            torch.cuda.synchronize()
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        self.t0 = time.perf_counter()

    def now(self):
        return time.perf_counter() - self.t0

    def mark(self):
        if self.cuda:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(self.now())

    def close(self):
        """Seconds from the start to the end, after a sync, and each
        call's completion in seconds."""
        if self.cuda:
            self.torch.cuda.synchronize()
        end = self.now()
        if self.cuda:
            done = [self.start.elapsed_time(e) * 1e-3 for e in self.marks]
        else:
            done = list(self.marks)
        return end, done


def run_window(entry, seconds, device, first_call=0):
    """Calls back to back for `seconds`: (calls, units, window s, latencies
    in s)."""
    win = Window(device)
    issued, units = [], 0
    i = first_call
    while win.now() < seconds:
        issued.append(win.now())
        units += entry.call(i)
        win.mark()
        i += 1
    end, done = win.close()
    return len(issued), units, end, [d - s for s, d in zip(issued, done)]


def card_name(device):
    import torch

    if torch.device(device).type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name()


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


class TraceRun:
    """What a per-layer metric's reader gets: the traced stretch's
    reduction and its number of calls, the untraced window's rate, and the
    entry's counts."""

    def __init__(self, trace, calls, rate, entry):
        self.trace = trace
        self.calls = calls
        self.rate = rate
        self.flops_per_unit = getattr(entry, "flops_per_unit", None)
        self.dcn_shapes = getattr(entry, "dcn_shapes", [])
        self.dtype = getattr(entry, "dtype", None)

    def range_ms_per_call(self, name):
        s = self.trace.range_seconds(name)
        return None if s is None or self.calls == 0 else s * 1e3 / self.calls

    def kernels_ms_per_call(self, fragments):
        """Device ms per call of the kernels whose name holds one of
        `fragments`, or None when there are none."""
        hit = [s for n, s in self.trace.kernel_seconds().items()
               if any(f in n for f in fragments)]
        return sum(hit) * 1e3 / self.calls if hit and self.calls else None


def run_cell(cell, seed, seconds, trace, device="cuda", t0=None):
    """Set up, measure and check one cell. Returns the result dict."""
    import torch

    from portbench import spec
    from portbench.yardstick.trace import RangeHooks, Trace, events_of

    t0 = T0 if t0 is None else t0
    torch.set_num_threads(1)
    module = importlib.import_module("portbench.entries."
                                     + cell.traffic["entry"])
    entry = module.Entry(cell, seed, device, log=log)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    # the reference's seconds in set-up (counts, weight calibration) are
    # the benchmark's, not the program's
    setup_s = time.perf_counter() - t0 - getattr(entry, "yardstick_s", 0.0)
    calls, units, window_s, lat = run_window(entry, seconds, device)
    rate = units / window_s
    log(f"window: {calls} calls, {units} {entry.unit}, {window_s:.3f} s")
    per_layer = {}
    device_info = {}
    breakdown = None
    if trace:
        readers = {m["name"]: cell.reader(m["name"])
                   for m in cell.per_layer()}
        n = int(cell.traffic["trace_calls"])
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        # one call warms the profiler up; the next n are traced
        sched = torch.profiler.schedule(wait=0, warmup=1, active=n,
                                        repeat=1)
        with RangeHooks(spec.ranges_of(readers)):
            with torch.profiler.profile(activities=activities,
                                        schedule=sched) as prof:
                for i in range(calls, calls + n + 1):
                    entry.call(i)
                    prof.step()
        tr = Trace(events_of(prof))
        device_info = {"busy_s": tr.busy_s, "window_s": tr.window_s}
        breakdown = tr.breakdown()
        run = TraceRun(tr, n, rate, entry)
        for name, mod in readers.items():
            v = mod.read(run)
            if v is not None:
                per_layer[name] = {"value": v, "unit": next(
                    m["unit"] for m in cell.per_layer() if m["name"] == name)}
        calls += n + 1
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    entry.close()
    t_check = time.perf_counter()
    checks, diag = entry.check()
    log(f"check: {time.perf_counter() - t_check:.1f} s over "
        f"{diag.pop('images', 0)} images; " + ", ".join(
            f"{k} {v}" for k, v in diag.items()))
    correct = all(lim is not None and v <= lim for _, v, lim in checks)
    metrics = {}
    if not trace:
        values = {"rate": rate, "latency_p95": percentile(lat, 95) * 1e3,
                  "setup": setup_s}
        kinds = dict(cell.traffic["report"], setup_s="setup")
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": values[kinds[m["name"]]],
                                  "unit": m["unit"]}
    else:
        metrics = per_layer
    dev = {"platform": "gpu" if torch.device(device).type == "cuda"
           else "cpu", "kind": card_name(device), "count": cell.chips,
           "memory_peak_bytes": int(peak)}
    dev.update(device_info)
    result = {"correct": bool(correct), "attempted": calls, "failed": 0,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    # a number that is not finite is written as null (strict JSON)
    result["checks"] = {k: {"value": v if math.isfinite(v) else None,
                            "limit": lim} for k, v, lim in checks}
    log(f"latency ms p50 {percentile(lat, 50) * 1e3:.3f} p95 "
        f"{percentile(lat, 95) * 1e3:.3f} max {max(lat) * 1e3:.3f}; rate "
        f"{rate:.3f}; setup {setup_s:.3f} s; peak {peak} B")
    for k, v, lim in checks:
        log(f"check {k} {v!r} limit {lim!r}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from portbench import spec

    cell = spec.Cell(spec.load_bench(), args.workload)
    import torch

    if not torch.cuda.is_available():
        log("portbench: CUDA is not available; no result")
        return 3
    if torch.cuda.device_count() < cell.chips:
        log(f"portbench: {cell.name} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} present; no result")
        return 3
    log(f"portbench: {cell.name} seed {args.seed} on {card_name('cuda')} "
        f"({power_limit()})")
    result = run_cell(cell, args.seed, args.seconds, args.trace)
    found = forbidden_modules()
    if found:
        log(f"portbench: loaded after the window: {', '.join(found)}; "
            "no result")
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

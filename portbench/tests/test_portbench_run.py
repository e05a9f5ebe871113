"""A whole run on the CPU at a tiny size (the card's look skipped), the
last line's shape, and the command's refusals."""

import json
import math
import os
import shutil
import subprocess
import sys

import pytest

from portbench import run, spec

ROOT = os.path.dirname(spec.HERE)


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_shape(tiny_cells, trace):
    cell = tiny_cells["detect.fullalign.b64"]
    res = run.run_cell(cell, 2 ** 31 + 12345, 0.3, trace, device="cpu")
    line = json.dumps(res, allow_nan=False)
    assert list(json.loads(line))[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(res)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    names = {m["name"] for m in (cell.per_layer() if trace
                                 else cell.end_to_end())}
    assert set(res["metrics"]) <= names
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(res["metrics"]) == names
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


def _cli(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "detect.fullalign.b64", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_no_card_no_result():
    out = _cli(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""

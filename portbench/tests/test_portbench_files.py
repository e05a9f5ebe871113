"""Every cell, configuration, traffic mix, limit and metric file parses,
keeps to the benchmark's contract, and their cross-references hold."""

import dataclasses
import importlib
import os
import re

import pytest

from portbench import spec
from portbench.entries.detect import program_conf

ROOT = os.path.dirname(spec.HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 65536


def test_names_units_and_references(bench):
    configs = {c["name"] for c in bench["configs"]}
    metrics = bench["end_to_end"] + bench["per_layer"]
    for entry in bench["configs"] + bench["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
    used = {w["config"] for w in bench["workloads"]}
    assert used == configs
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("name", ["detect.fullalign.b64", "detect.base.b64"])
def test_cell_files(cells, name):
    cell = cells[name]
    importlib.import_module("portbench.entries." + cell.traffic["entry"])
    assert cell.end_to_end() and cell.per_layer()
    for m in cell.per_layer():
        assert callable(cell.reader(m["name"]).read)
    for k in cell.traffic["report"]:
        assert k in {m["name"] for m in cell.end_to_end()}
    for number, lim in cell.limits.items():
        assert lim["limit"] > 0, number
        if lim.get("lower") is not None:
            assert lim["lower"] < lim["limit"] < lim["upper"]


@pytest.mark.parametrize("name", ["m3dssd-fullalign-dla102",
                                  "m3dssd-base-dla102"])
def test_config_file_matches_program_config(cells, name):
    cell = next(c for c in cells.values()
                if c.config_entry["name"] == name)
    assert cell.config["name"] == name
    conf = program_conf(cell)
    fields = {f.name for f in dataclasses.fields(conf)}
    model = cell.config["model"]
    checked = 0
    for key, value in model.items():
        key = {"backbone": "back_bone"}.get(key, key)
        if key in fields:
            got = getattr(conf, key)
            assert (list(got) if isinstance(got, (list, tuple)) else got) \
                == value, key
            checked += 1
    assert checked >= 15

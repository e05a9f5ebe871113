"""The benchmark's definition, read from files by name.

`BENCHMARK.json` (at the root of the checkout) names the cells; a cell's
traffic is `traffic/<traffic>.json` (the entry that drives it and its
parameters), its configuration the file its `configs` entry names, its
limits `limits/<cell>.json`, and each per-layer metric a reader
`metrics/<metric>.py`. Adding a cell, a mix, a configuration or a metric is
adding files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))


class Cell:
    """One workload of BENCHMARK.json with everything it refers to."""

    def __init__(self, bench: dict, name: str, root: str = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                           f"{sorted(cells)}")
        self.bench = bench
        self.root = root
        self.workload = cells[name]
        self.name = name
        self.chips = int(self.workload["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = load_json(os.path.join(
            os.path.dirname(root), self.config_entry["file"]))
        self.traffic = load_json(os.path.join(
            root, "traffic", self.workload["traffic"] + ".json"))
        path = os.path.join(root, "limits", name + ".json")
        # a cell without limits yet reads as not correct
        self.limits = load_json(path) if os.path.exists(path) else {}

    def end_to_end(self) -> List[dict]:
        return [m for m in self.bench["end_to_end"] if self._has(m)]

    def per_layer(self) -> List[dict]:
        moves = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"] if m["moves"] in moves
                and self._has(m)]

    def _has(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def reader(self, metric: str):
        """The module of metrics/<metric>.py."""
        return load_module(os.path.join(self.root, "metrics",
                                        metric + ".py"))


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    name = "portbench_file_" + os.path.basename(path)[:-3].replace(
        ".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_bench(path: Optional[str] = None) -> dict:
    return load_json(path or os.path.join(os.path.dirname(HERE),
                                          "BENCHMARK.json"))


def ranges_of(readers: Dict[str, object]) -> Dict[str, List[str]]:
    """{range name: module class names} that the readers ask for."""
    out = {}
    for mod in readers.values():
        out.update(getattr(mod, "RANGES", {}))
    return out

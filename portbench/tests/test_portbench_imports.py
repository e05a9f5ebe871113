"""Nothing the benchmark loads or imports is JAX or the JAX package, and
the reference imports nothing of the program. Top-level module names (the
part before the first dot) are compared whole: the port's name begins
with the JAX package's."""

import ast
import os
import subprocess
import sys

from portbench import run, spec

ROOT = os.path.dirname(spec.HERE)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(top):
    for d, _, files in os.walk(top):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_jax_import_in_sources():
    for path in _sources(spec.HERE):
        bad = set(_imports(path)) & set(run.FORBIDDEN)
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_program():
    for path in _sources(os.path.join(spec.HERE, "reference")):
        assert "m3dssd_tpu_torch" not in set(_imports(path)), path


DRY_RUN = """
import sys, torch
torch.set_num_threads(1)
sys.path.insert(0, {tests!r})
from conftest import tiny
from portbench import run, spec
cell = tiny(spec.Cell(spec.load_bench(), "detect.base.b64"))
run.run_cell(cell, 3, 0.2, 0, device="cpu")
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_dry_run_loads_no_jax():
    code = DRY_RUN.format(tests=os.path.join(spec.HERE, "tests"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "m3dssd_tpu_torch" in loaded
    assert not loaded & set(run.FORBIDDEN)

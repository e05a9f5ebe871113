"""Run-directory source snapshot, so that a checkpoint keeps running with
the code that trained it.

The port's counterpart of the reference package's
`utils/source_snapshot.py`. At training start the whole
`m3dssd_tpu_torch` package is copied into
`<run_dir>/model_src/m3dssd_tpu_torch/`; the test CLI
(`m3dssd_tpu_torch.scripts.test`) puts `<run_dir>/model_src` first on
sys.path before it imports the package, so evaluating an old run uses the
training-time code even after the live package has changed.

The CUDA sources (`csrc/`) are copied with the Python: the kernels are part
of the forward the checkpoint must reproduce, and the snapshot builds them
into its own `_build/` at first use. Build outputs (`_build/`, `*.so`,
`*.o`) and bytecode caches are left out. The native AP engine's source
(repo-level `native/`) is host-side evaluation tooling and stays where it
is; the test CLI points `M3DSSD_NATIVE_DIR` at it.
"""

from __future__ import annotations

import logging
import os
import shutil
import time

PACKAGE = "m3dssd_tpu_torch"
_IGNORE = ("_build", "__pycache__", "*.pyc", "*.so", "*.o")


def snapshot_source(run_dir: str) -> str:
    """Copy the live package into `<run_dir>/model_src/`, replacing a
    previous snapshot (a resumed run snapshots the code that runs now).
    Returns the directory to put first on sys.path."""
    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dest_root = os.path.join(run_dir, "model_src")
    dest = os.path.join(dest_root, PACKAGE)
    if os.path.exists(dest):
        shutil.rmtree(dest)
    shutil.copytree(pkg_dir, dest, ignore=shutil.ignore_patterns(*_IGNORE))
    with open(os.path.join(dest_root, "SNAPSHOT.txt"), "w") as f:
        f.write(f"source: {pkg_dir}\n"
                f"time: {time.strftime('%Y-%m-%d %H:%M:%S')}\n")
    logging.info("model source snapshot: %s", dest_root)
    return dest_root


def snapshot_path(run_dir: str):
    """`<run_dir>/model_src` when a snapshot exists there, else None."""
    p = os.path.join(run_dir, "model_src")
    return p if os.path.isdir(os.path.join(p, PACKAGE)) else None

"""Build the port's CUDA sources (`csrc/*.cu`) into shared libraries.

Each source is compiled by `nvcc` for Hopper (`sm_90a`) into a library with
a plain C interface, loaded with `ctypes` by its wrapper (`dcn_cuda.py`):
`dcn_shift.cu` holds the shift-DCN forward, `dcn_shift_bwd.cu` its
backward. The build happens at first use, into `m3dssd_tpu_torch/_build/`
(listed in .gitignore), under a name that carries a hash of the source and
the flags, so an edited source is rebuilt and an unchanged one is reused.
`build()` starts one `nvcc` per missing library, all at once.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from typing import Dict, Optional, Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = {name: os.path.join(_PKG, "csrc", f"{name}.cu")
           for name in ("dcn_shift", "dcn_shift_bwd")}
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> str:
    with open(SOURCES[name], "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names: Optional[Sequence[str]] = None) -> Dict[str, Tuple[str, str]]:
    """Compile each named source (default: all) unless its library exists.

    Returns {name: (library path, nvcc's report of registers, shared memory
    and spills; "" when the library was reused)}. Raises with nvcc's output
    if a compile fails.
    """
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    out, running = {}, {}
    for name in names:
        path = library_path(name)
        if os.path.exists(path):
            out[name] = (path, "")
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        running[name] = (path, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCES[name]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (path, tmp, proc) in running.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {SOURCES[name]} (exit "
                          f"{proc.returncode}):\n{report}")
            continue
        os.replace(tmp, path)
        out[name] = (path, report)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out

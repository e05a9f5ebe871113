"""Build the port's CUDA source `csrc/dcn_shift.cu` into a shared library.

The source is compiled by `nvcc` for Hopper (`sm_90a`) into a library with
a plain C interface, loaded with `ctypes` by its wrapper (`dcn_cuda.py`).
The build happens at first use, into `m3dssd_tpu_torch/_build/` (listed in
.gitignore), under a name that carries a hash of the source and the flags,
so an edited source is rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from typing import Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "dcn_shift.cu")
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


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libdcn_shift-{digest.hexdigest()[:12]}.so")


def build() -> Tuple[str, str]:
    """Compile the source unless its library exists.

    Returns (library path, nvcc's report of registers, shared memory and
    spills; "" when the library was reused). Raises with nvcc's output if
    the compile fails.
    """
    path = library_path()
    if os.path.exists(path):
        return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCE} (exit "
                           f"{res.returncode}):\n{res.stdout}")
    os.replace(tmp, path)
    return path, res.stdout

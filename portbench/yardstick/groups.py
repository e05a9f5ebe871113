"""Kernel-name groups of a device trace.

Copied from `profile_detect.py:group_of` (GROUPS and group_of), so that a
later change to the program's scripts does not move the yardstick."""

from __future__ import annotations

GROUPS = (("shift-DCN kernel", ("dcn_shift",)),
          ("convolution", ("conv", "cudnn", "xmma", "implicit", "winograd",
                           "fft", "dgrad", "wgrad", "fprop")),
          ("matmul", ("gemm", "cutlass", "matmul")),
          ("gather / scatter / index", ("index", "gather", "scatter",
                                        "take")),
          ("reduction / argmax / sort", ("reduce", "argmax", "max", "sort",
                                         "scan", "cumsum", "search")),
          ("copy / layout", ("copy", "cat", "permute", "contiguous",
                             "transpose", "memcpy", "memset", "fill")),
          ("elementwise", ("elementwise", "vectorized", "unrolled")))


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"

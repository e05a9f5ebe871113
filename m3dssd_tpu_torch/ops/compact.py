"""First-m stream compaction without sorting."""

from __future__ import annotations

import torch


def first_m_true(flags: torch.Tensor, m: int):
    """Indices of the first `m` True entries of a flat bool vector, in order
    of appearance.

    flags [N] -> (idx [m] int64 with sentinel N in unused slots,
    ok: 0-dim bool tensor, total True count <= m).
    """
    ranks = torch.cumsum(flags.to(torch.int64), 0)
    want = torch.arange(1, m + 1, dtype=torch.int64, device=flags.device)
    idx = torch.searchsorted(ranks, want, right=False)
    return idx, ranks[-1] <= m

"""First-m stream compaction without sorting."""

from __future__ import annotations

import torch


def first_m_true(flags: torch.Tensor, m: int):
    """Indices of the first `m` True entries of each row of a bool tensor,
    in order of appearance.

    flags [..., N] -> (idx [..., m] int64 with sentinel N in unused slots,
    ok [...] bool: the row's True count <= m; 0-dim for a flat vector).
    """
    ranks = torch.cumsum(flags.to(torch.int64), -1)
    want = torch.arange(1, m + 1, dtype=torch.int64, device=flags.device)
    want = want.expand(*flags.shape[:-1], m).contiguous()
    idx = torch.searchsorted(ranks, want, right=False)
    return idx, ranks[..., -1] <= m

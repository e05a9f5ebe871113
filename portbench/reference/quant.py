"""The control's precision: a tensor rounded to float8 e4m3 with one scale
per tensor (its largest magnitude onto e4m3's largest, 448), then computed
on in float32. One step below the configurations' bfloat16."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    if not t.is_floating_point() or t.numel() == 0:
        return t
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return ((t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale)

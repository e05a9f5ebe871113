"""Where the port's entry points run."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names a device.

    `None` means `cuda`; it raises when no card is present, so a run that
    was meant for the card never drops to the CPU unnoticed. Pass
    `device="cpu"` to run the plain PyTorch ops on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev

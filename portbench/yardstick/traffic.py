"""Inputs of a cell from its traffic parameters and the run's seed: a pool
of image batches made on the device, the same sizes for every seed."""

from __future__ import annotations

import torch

# streams of one seed: weights and inputs are drawn apart
WEIGHTS, INPUTS, CALIBRATION = 0, 1, 2


def stream_seed(seed: int, stream: int) -> int:
    return (int(seed) * 2 + stream) % (2 ** 63)


def space_to_depth(x):
    """[B, H, W, C] -> [B, H/2, W/2, 4C]: packed channel (2a+b)*C + c holds
    pixel (2i+a, 2j+b, c)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // 2, 2, W // 2, 2, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H // 2, W // 2, 4 * C)


def image_pool(traffic: dict, seed: int, device):
    """`pool` batches of `batch` preprocessed images [B, H, W, 3] (standard
    normal pixels), and each image's scale factor."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, INPUTS))
    H, W = traffic["height"], traffic["width"]
    B, n = traffic["batch"], traffic["pool"]
    images = torch.randn((n, B, H, W, 3), generator=gen, device=device)
    sf = torch.full((B,), float(traffic["scale_factor"]), device=device)
    return list(images.unbind(0)), sf

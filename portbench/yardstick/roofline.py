"""The card's peaks, and the operations and bytes a call needs.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, 700 W). The
shift-DCN forward's bound is copied from `chip_smoke.py:shift_dcn_bound`
(with PEAK_FLOPS and PEAK_BYTES), and the model's operations
are counted on the benchmark's own reference at the cell's shapes, so a
later change to the program does not move the yardstick.
"""

from __future__ import annotations

import math
from collections import defaultdict

import torch

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12


def shift_dcn_bound(B, H, W, C, Cout, dtype, K=3):
    """(ms the bytes need, ms the operations need) for one shift-DCN call:
    each input read once and the output written once, against the product
    (2 per MAC) plus a 4-corner bilinear sample (8 per sampled element),
    at the card's peak for dtype."""
    es = torch.finfo(dtype).bits // 8
    KK = K * K
    P = B * H * W
    nbytes = (P * C * es + P * KK * 2 * 4 + P * KK * 4 + KK * C * Cout * es
              + Cout * 4 + P * Cout * es)
    flops = 2.0 * P * KK * C * Cout + 8.0 * P * KK * C
    return nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype] * 1e3


def model_counts(cfg: dict, anchors, means, stds):
    """One forward of the reference on `meta` tensors at one image of the
    configuration's input size. Returns (weight spec {name: (shape, kind,
    fan_in)}, the neck's DCN shapes (B=1), FLOPs by stage, weight elements
    by stage). The convolutions and products are counted, 2 per
    multiply-add (`Ref.flops`; as torch.utils.flop_counter counts, which
    the tests hold it to); the alignment layers once per position, as
    their dense form (a sparse path adds a correction at the few confident
    positions, not counted)."""
    from ..reference.model import Params, Ref

    params = Params(record=True)
    ref = Ref(cfg, params, anchors=anchors, means=means, stds=stds)
    flops, weights = defaultdict(int), defaultdict(int)
    state = {"stage": "input", "flops": 0, "names": 0}

    def on_stage(name):
        names = list(params.spec)
        flops[state["stage"]] += ref.flops - state["flops"]
        weights[state["stage"]] += sum(
            math.prod(params.spec[n][0]) for n in names[state["names"]:])
        state.update(stage=name, flops=ref.flops, names=len(names))

    ref.on_stage = on_stage
    H, W = cfg["test_scale"]
    ref.forward(torch.zeros((1, H, W, 3), device="meta"))
    on_stage("end")
    return (params.spec, list(ref.dcn_shapes),
            {k: v for k, v in flops.items() if v},
            {k: v for k, v in weights.items() if v})

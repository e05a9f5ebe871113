"""The operation and byte counts against hand counts."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference.model import Params, Ref
from portbench.yardstick.roofline import (PEAK_BYTES, PEAK_FLOPS,
                                          model_counts, shift_dcn_bound)
from portbench.reference.anchors import synthetic_anchors

torch.set_num_threads(1)


def _ref():
    return Ref({}, Params(record=True))


def test_conv_flops_by_hand():
    x = torch.zeros((2, 8, 10, 12), device="meta")
    with FlopCounterMode(display=False) as c:
        _ref().conv(x, "c", 16, 3)
    assert c.get_total_flops() == 2 * 2 * 16 * 10 * 12 * 8 * 9


def test_dcn_flops_by_hand():
    x = torch.zeros((1, 8, 6, 7), device="meta")
    off = torch.zeros((1, 6, 7, 9, 2), device="meta")
    mask = torch.zeros((1, 6, 7, 9), device="meta")
    with FlopCounterMode(display=False) as c:
        _ref().dcn(x, "d", off, mask, 3, 1, 5)
    # the product of the columns [P, 9 C] with the weight [9 C, Cout]
    assert c.get_total_flops() == 2 * (6 * 7) * 9 * 8 * 5


def test_shift_dcn_bound_by_hand():
    B, H, W, C, Co = 2, 3, 5, 16, 8
    P = B * H * W
    nbytes = (P * C * 2 + P * 9 * 2 * 4 + P * 9 * 4 + 9 * C * Co * 2
              + Co * 4 + P * Co * 2)
    ops = 2.0 * P * 9 * C * Co + 8.0 * P * 9 * C
    b_ms, o_ms = shift_dcn_bound(B, H, W, C, Co, torch.bfloat16)
    assert abs(b_ms - nbytes / PEAK_BYTES * 1e3) < 1e-15
    assert abs(o_ms - ops / PEAK_FLOPS[torch.bfloat16] * 1e3) < 1e-15


def test_model_counts_cover_every_stage(tiny_cells):
    cfg = tiny_cells["detect.fullalign.b64"].config["model"]
    anchors, means, stds = synthetic_anchors(cfg)
    spec, shapes, flops, weights = model_counts(cfg, anchors, means, stds)
    assert set(flops) == {"backbone", "neck", "head", "align", "anab"}
    # DLA-34's stem: a 7x7 conv of 3 -> 16 channels at full resolution
    assert spec["base.base.base_conv.weight"][0] == (16, 3, 7, 7)
    assert len(shapes) == 8 and all(s[0] == 1 for s in shapes)
    assert sum(weights.values()) == sum(
        torch.Size(s).numel() for s, _, _ in spec.values())


def test_model_counts_match_the_flop_counter(tiny_cells):
    """The reference's own count equals torch.utils.flop_counter's over a
    whole forward of both configurations."""
    for name in ("detect.fullalign.b64", "detect.base.b64"):
        cfg = tiny_cells[name].config["model"]
        anchors, means, stds = synthetic_anchors(cfg)
        _, _, flops, _ = model_counts(cfg, anchors, means, stds)
        ref = Ref(cfg, Params(record=True), anchors=anchors, means=means,
                  stds=stds)
        H, W = cfg["test_scale"]
        with FlopCounterMode(display=False) as c:
            ref.forward(torch.zeros((1, H, W, 3), device="meta"))
        assert sum(flops.values()) == c.get_total_flops() == ref.flops

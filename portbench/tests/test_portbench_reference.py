"""The frozen reference against the port, on the CPU at a tiny size: the
flagship (and the baseline) on DLA-34 at 64x128 in float32, with the
benchmark's calibrated weights, so that some positions are confident and
some rows of the table are detections."""

import pytest
import torch

import portbench.entries.detect as D

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["detect.fullalign.b64", "detect.base.b64"])
def test_reference_matches_port_float32(tiny_cells, name):
    entry = D.Entry(tiny_cells[name], 20241018, "cpu", log=lambda *a: None)
    for i in range(2):
        entry.call(i)
    entry.close()
    worst, _ = entry.readings()
    # the same arithmetic in float32 on both sides: rounding only
    for number in ("cls_err", "score_err", "box_err"):
        assert worst[number] < 1e-4, number
    assert worst["cls_gap"] < 1e-3
    assert worst["dets_err"] < 1e-5


def test_reference_table_holds_detections(tiny_cells):
    entry = D.Entry(tiny_cells["detect.fullalign.b64"], 7, "cpu",
                    log=lambda *a: None)
    entry.call(0)
    entry.close()
    _, got, dets = entry.kept[0]
    ref = entry.reference_dets(got)
    assert int((dets[..., 4] >= 0).sum()) > 0
    assert torch.allclose(dets.float(), ref, rtol=1e-6, atol=1e-4)


def _two_boxes(iou):
    """Boxes [x1, y1, x2, y2] of height 1 and width 100 whose IoU (areas
    with +1 pixel) is `iou`, and their scores, the first the better."""
    x = 100.0 * (1.0 - iou) / (1.0 + iou)
    boxes = torch.tensor([[0.0, 0.0, 99.0, 0.0], [x, 0.0, x + 99.0, 0.0]],
                         dtype=torch.float64)
    return boxes, torch.tensor([0.9, 0.8], dtype=torch.float64)


@pytest.mark.parametrize("above, judged, kept", [
    (3e-5, None, [0]),             # the reference alone suppresses
    (3e-5, [True, True], [0, 1]),  # within the margin: the table's way
    (3e-5, [True, False], [0]),
    (-3e-5, [True, False], [0]),   # either way within the margin
    (1e-2, [True, True], [0]),     # outside it the reference decides
    (-1e-2, [True, False], [0, 1]),
])
def test_nms_follows_the_table_only_within_the_margin(above, judged, kept):
    from portbench.reference.decode import greedy_nms

    boxes, scores = _two_boxes(0.4 + above)
    got = greedy_nms(boxes, scores, 0.4, 0.5, 40,
                     None if judged is None else torch.tensor(judged))
    assert got == kept

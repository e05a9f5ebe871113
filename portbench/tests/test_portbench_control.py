"""The check fails what it must. The control (the reference in float8, put
in the program's place) comes out not correct, here at the CPU test size
and, where a card is present, at the cell's own size on three seeds; and
whole runs with the timed path broken underneath come out not correct:
an answer altered where it is produced and half of the batch left out,
here; NMS that suppresses nothing, at the cell's own size on the card, on
every seed whose sample the reference's NMS suppresses in (most seeds; the
CPU size's anchors, 4 to 48 pixels at a stride of 8, seldom overlap, so
there NMS has little to suppress). The faults are `portbench/faults.py`'s."""

import pytest
import torch

import portbench.entries.detect as D
from portbench import faults, run

torch.set_num_threads(1)
CELLS = ["detect.fullalign.b64", "detect.base.b64"]


def _fails(readings, limits):
    return [k for k, v in readings.items() if not v <= limits[k]["limit"]]


@pytest.mark.parametrize("name", CELLS)
def test_control_not_correct_cpu(tiny_cells, name):
    cell = tiny_cells[name]
    entry = D.Entry(cell, 99, "cpu", log=lambda *a: None)
    entry.call(0)
    entry.close()
    program, _ = entry.readings()
    control, _ = entry.readings(control=True)
    assert not _fails(program, cell.limits)
    assert _fails(control, cell.limits)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_not_correct_card(cells, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench.calibrate import readings

    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        out = readings(cells[name], seed, 4, control=True)
        assert not _fails(out["program"], cells[name].limits)
        assert _fails(out["control"], cells[name].limits)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_no_suppression_not_correct_card(cells, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench.calibrate import readings

    exercised = 0
    for seed in range(2 ** 31 + 4, 2 ** 31 + 9):
        out = readings(cells[name], seed, 4, control=False,
                       fault="no_suppression")
        # a sample in which the reference's NMS suppressed nothing cannot
        # tell a program without suppression from a sound one
        if out["diagnostics"]["images_nms_suppressed"]:
            exercised += 1
            assert _fails(out["program"], cells[name].limits), seed
    assert exercised >= 3


@pytest.mark.parametrize("fault", ["altered_answer", "half_batch"])
def test_broken_timed_path_not_correct(tiny_cells, fault):
    with faults.FAULTS[fault]():
        res = run.run_cell(tiny_cells["detect.fullalign.b64"], 5, 0.3, 0,
                           device="cpu")
    assert res["correct"] is False

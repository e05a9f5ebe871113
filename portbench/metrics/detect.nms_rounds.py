"""detect.nms_rounds (count): NMS rounds per detect call, the program's
`m3dssd.nms.round` spans (one a first-k selection round of
ops/nms.py:nms_select_t, or one a step of the bitmask fixpoint). Moves
detect_images_per_s."""

from portbench.yardstick.spans import spans_per_call


def read(run):
    return spans_per_call(run, "m3dssd.nms.round")

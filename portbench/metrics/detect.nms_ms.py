"""detect.nms_ms (ms): device time per detect call of the kernels launched
inside the program's span `m3dssd.nms` (ops/nms.py: nms_select_t's greedy
rounds, or the bitmask fixpoint). Moves detect_images_per_s."""

from portbench.yardstick.spans import device_ms


def read(run):
    return device_ms(run, ["m3dssd.nms"])

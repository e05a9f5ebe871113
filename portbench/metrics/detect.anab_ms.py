"""detect.anab_ms (ms): device time per detect call of the kernels
launched inside the program's span `m3dssd.anab` (models/attention.py:ANAB
with its BatchNorm and activation in models/rpn.py). Moves
detect_images_per_s."""

from portbench.yardstick.spans import device_ms


def read(run):
    return device_ms(run, ["m3dssd.anab"])

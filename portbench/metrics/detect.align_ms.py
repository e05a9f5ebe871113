"""detect.align_ms (ms): device time per detect call of the kernels
launched inside the program's align spans, `m3dssd.align.select`
(confident_topm), `.shape`, `.center2d` and `.center3d` (models/align.py).
Moves detect_images_per_s."""

from portbench.yardstick.spans import device_ms, named


def read(run):
    return device_ms(run, named(run, "m3dssd.align."))

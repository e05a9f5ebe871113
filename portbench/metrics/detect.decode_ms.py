"""detect.decode_ms (ms): device time per detect call of the kernels
launched inside the program's span `m3dssd.decode` (inference/detect.py:
_Decoder.finish: the 2D and 3D box decode of every candidate; ops/boxes.py).
Moves detect_images_per_s."""

from portbench.yardstick.spans import device_ms


def read(run):
    return device_ms(run, ["m3dssd.decode"])

"""detect.base_ms (ms): device time per detect call of the kernels launched
inside the backbone and neck (the forward of DLASeg, models/dla.py and
models/necks.py). Moves detect_images_per_s."""

RANGES = {"base": ["DLA", "DLAUp", "IDAUp"]}


def read(run):
    return run.range_ms_per_call("base")

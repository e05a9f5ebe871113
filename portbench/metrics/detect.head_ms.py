"""detect.head_ms (ms): device time per detect call of the kernels launched
inside the model's forward (M3DRPN) but outside its backbone and neck: the
towers, shape and center alignment and ANAB (models/rpn.py, align.py,
attention.py). Moves detect_images_per_s."""

RANGES = {"M3DRPN": ["M3DRPN"], "base": ["DLA", "DLAUp", "IDAUp"]}


def read(run):
    whole = run.range_ms_per_call("M3DRPN")
    base = run.range_ms_per_call("base")
    if whole is None or base is None:
        return None
    return whole - base

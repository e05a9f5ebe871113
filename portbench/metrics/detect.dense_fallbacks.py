"""detect.dense_fallbacks (count): dense fallbacks per detect call, the
program's `m3dssd.fallback.<site>` spans: the dense branch a sparse path
takes when its budget overflows (models/align.py's align modules,
inference/detect.py's sparse pre-NMS). Moves detect_images_per_s."""

from portbench.yardstick.spans import spans_per_call


def read(run):
    return spans_per_call(run, "m3dssd.fallback.")

"""detect.mfu (%): the whole detect step's share of the card's bf16 peak:
the reference's FLOPs per image at the cell's shapes (convolutions and
products, `yardstick/roofline.py:model_counts`) times the images per second
of the untraced window, over 989 TFLOP/s. Moves detect_images_per_s."""

from portbench.yardstick.roofline import PEAK_FLOPS


def read(run):
    if not run.flops_per_unit or not run.rate:
        return None
    return 100.0 * run.flops_per_unit * run.rate / PEAK_FLOPS[run.dtype]

"""detect.device_idle (%): the share of the traced stretch of detect calls
in which no operation ran on the card: 1 - union of device-operation
intervals / the stretch from the first operation's start to the last's
end. Moves detect_images_per_s."""


def read(run):
    t = run.trace
    if t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)

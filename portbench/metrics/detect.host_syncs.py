"""detect.host_syncs (count): host syncs per detect call, the program's
`m3dssd.sync.<site>` spans (utils/profiling.py: every read-back of a device
value on the detect path, and each copy that waits for the card). Moves
detect_images_per_s."""

from portbench.yardstick.spans import spans_per_call


def read(run):
    return spans_per_call(run, "m3dssd.sync.")

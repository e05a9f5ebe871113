"""detect.sync_idle_ms (ms): idle time of the card per detect call in the
gaps that begin while the host waits inside one of the program's
`m3dssd.sync.<site>` spans and last past the span's end: the card ran dry
during the wait and stayed idle until the host's next launch reached it.
The bubbles between kernels already queued, while the host waits, end
inside the span and do not count. Moves detect_images_per_s."""

from portbench.yardstick.spans import drained_idle_ms


def read(run):
    return drained_idle_ms(run, "m3dssd.sync.")

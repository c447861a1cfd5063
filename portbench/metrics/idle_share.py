"""The device's idle share of the profiled slice: 1 - (the union of the
intervals in which a kernel, copy or memset ran) / (the slice's wall time,
from its first device activity to its last)."""

LAYER = "device"
UNIT = "%"
MOVES = "images_per_s"
SOURCE = "device_trace"


def read(run):
    if run.slice is None or run.slice.wall_s <= 0:
        return None
    return 100.0 * (1.0 - run.slice.busy_s / run.slice.wall_s)

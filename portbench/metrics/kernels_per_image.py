"""Device kernels the profiled slice's own calls launched, over the
slice's images: an exact count, which fusion and fewer casts lower."""

LAYER = "models and ops"
UNIT = "kernels"
MOVES = "images_per_s"
SOURCE = "device_trace"


def read(run):
    if run.slice is None:
        return None
    return len(run.slice.kernels) / run.slice.images

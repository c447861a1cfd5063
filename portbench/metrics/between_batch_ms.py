"""Device-clock gap between one batch's end and the next batch's start,
summed over the batches before the profiled slice, over their count: the
driver's batch assembly, copy-back and PNG hand-off that the card waits
through (CUDA events on the stream around each expand call)."""

LAYER = "entry point"
UNIT = "ms"
MOVES = "images_per_s"
SOURCE = "device_trace"


def read(run):
    recs = run.timed
    if len(recs) < 2:
        return None
    return sum(a.end.elapsed_time(b.start) for a, b in zip(recs, recs[1:])) / (len(recs) - 1)

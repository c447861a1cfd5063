"""Device-clock milliseconds of SplitExpand's ``init_span`` (img2img
noising and the plain steps to the guidance window) and ``span_decode``
(the plain steps after it and the final decode), summed over the batches
before the profiled slice, over their images."""

LAYER = "pipeline"
UNIT = "ms"
MOVES = "images_per_s"
SOURCE = "device_trace"


def read(run):
    if not run.timed:
        return None
    ms = run.span_ms("init_span") + run.span_ms("span_decode")
    return ms / (len(run.timed) * run.batch)

"""Device-clock milliseconds of SplitExpand's ``guide`` (the rollout, its
decodes and guide, the backward, the gamma/beta step and the clip), summed
over the batches before the profiled slice, over their images; nothing
where the cell runs no guidance."""

LAYER = "guidance"
UNIT = "ms"
MOVES = "images_per_s"
SOURCE = "device_trace"


def read(run):
    if not run.timed or not any(r.spans.get("guide") for r in run.timed):
        return None
    return run.span_ms("guide") / (len(run.timed) * run.batch)

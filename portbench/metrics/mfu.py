"""The whole step's share of the card's bf16 peak: the FLOPs the recipe
needs for the images of the batches before the profiled slice
(``portbench/work/flops.py``: counted once, without the program's
recomputation), over the device-clock seconds from the first of those
batches' start to the last one's end, over 989 TFLOP/s (dense bf16, H100
SXM data sheet, at 700 W)."""

from portbench.work.peaks import PEAK_BF16_FLOPS

LAYER = "whole call"
UNIT = "%"
MOVES = "images_per_s"
SOURCE = "device_trace"


def read(run):
    recs = run.timed
    if not recs:
        return None
    seconds = recs[0].start.elapsed_time(recs[-1].end) / 1e3
    return 100.0 * run.flops_per_image() * len(recs) * run.batch / seconds / PEAK_BF16_FLOPS

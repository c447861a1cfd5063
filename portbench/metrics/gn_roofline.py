"""GroupNorm kernels' share of their roofline in the profiled slice: the
least time the recipe's GroupNorm forwards need (``portbench/work/
groupnorm.py``: the slab read once and written once), over the device time
of the kernels that normalise by group: the port's and PyTorch's own."""

from portbench.work import groupnorm

LAYER = "kernels"
UNIT = "%"
MOVES = "images_per_s"
SOURCE = "device_trace"
PATTERNS = ("gn::", "group_norm", "groupnorm", "computefusedparams")


def read(run):
    if run.slice is None:
        return None
    spent = run.slice.kernel_seconds(PATTERNS)
    if spent <= 0:
        return None
    need = groupnorm.needed_bound_s(run.cfg, run.traffic) * run.profiled
    return 100.0 * need / spent

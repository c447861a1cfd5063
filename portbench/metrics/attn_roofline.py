"""The port's flash kernels' share of their roofline in the profiled slice:
the least time their launches need (``portbench/work/attention.py``
``bound_s`` of each launch's kernel and shape: bytes read and written once,
products at the tensor cores' peak), over those kernels' device time.

Both sides count the same work, the flash kernels' own: the launches come
from the program's counters (``ops/flash.py`` ``launch_shapes``, the
window's over its batches), and the time from the kernels in the port's
``flash::`` and ``flash32::`` namespaces (not PyTorch's ``pytorch_flash::``).
Recomputation under ``rollout_remat`` is work those kernels do, so it
counts. Attention that runs elsewhere (the program's plain path at 256 kv
tokens or fewer, or a library kernel) is on neither side; where the flash
kernels run nothing, or their counters are gone, the metric reads nothing,
and ``mfu`` still bounds the whole step."""

import re

from portbench.work import attention

LAYER = "kernels"
UNIT = "%"
MOVES = "images_per_s"
SOURCE = "device_trace"
PORT_KERNEL = re.compile(r"(?<![A-Za-z0-9_])flash(32)?::")


def read(run):
    if run.slice is None or not run.flash_launches:
        return None
    spent = sum(e[3] - e[2] for e in run.slice.kernels if PORT_KERNEL.search(e[0])) / 1e9
    itemsize = 4 if run.cfg["dtype"] == "float32" else 2
    need = sum(n * attention.bound_s(kernel, *shape, itemsize=itemsize)
               for (kernel, shape), n in run.flash_launches.items()) * run.profiled
    if spent <= 0 or need <= 0:
        return None
    return 100.0 * need / spent

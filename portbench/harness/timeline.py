"""Reading a profiled slice: the device's busy intervals and idle gaps, the
kernels by name and family, and what the host was doing in each gap.

All times are nanoseconds on the profiler's clock. "Busy" is the union of the
intervals in which a kernel, a copy or a memset ran on the device; the slice
runs from the first device activity that the slice's own host calls launched
to the end of the last device activity.
"""

from __future__ import annotations

import collections
import heapq
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_ACTIVITIES = ("cpu_op", "user_annotation")

# kernel families, by substrings of the lower-cased kernel name, first match
CATEGORIES = [
    ("flash kernels (port)", ("flash::", "flash32::")),
    ("groupnorm kernels (port)", ("gn::",)),
    ("convolution (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd")),
    ("matmul (cuBLAS)", ("gemm", "nvjet", "cutlass", "gemv", "splitk")),
    ("reduction (norm statistics, softmax)", ("reduce", "softmax", "norm", "bn_fw")),
    ("elementwise and copies", ("elementwise", "vectorized", "unrolled", "copy", "cat",
                                "index", "fill", "memset", "memcpy", "upsample",
                                "interpolate", "pool", "tonchw", "tonhwc")),
]


def category(name: str) -> str:
    low = name.lower()
    return next((c for c, keys in CATEGORIES if any(k in low for k in keys)), "other")


def merge(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of intervals, as sorted disjoint intervals."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_ns(intervals, lo: int, hi: int) -> int:
    """Length of the union of ``intervals`` inside [lo, hi]."""
    return sum(max(0, min(b, hi) - max(a, lo)) for a, b in merge(intervals))


def gaps(intervals, lo: int, hi: int) -> List[Tuple[int, int]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for a, b in merge(intervals):
        if b <= lo or a >= hi:
            continue
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return out


def label_gaps(gap_list: Sequence[Tuple[int, int]],
               host: Sequence[Tuple[str, int, int]]) -> List[str]:
    """For each gap, the host operation running at its start: of the host
    events (name, start, end) covering that moment, the one that began last
    (the innermost); "(host between operations)" where none does."""
    order = sorted(range(len(gap_list)), key=lambda i: gap_list[i][0])
    events = sorted(host, key=lambda e: e[1])
    labels: List[str] = [""] * len(gap_list)
    active: list = []  # max-heap by start: (-start, end, name)
    j = 0
    for i in order:
        t = gap_list[i][0]
        while j < len(events) and events[j][1] <= t:
            name, a, b = events[j]
            heapq.heappush(active, (-a, b, name))
            j += 1
        while active and active[0][1] < t:
            heapq.heappop(active)
        # an event that ended before t may sit below the top: skip it lazily
        labels[i] = active[0][2] if active else "(host between operations)"
    return labels


def top(items: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(items.items(), key=lambda kv: -kv[1])[:n]]


class Slice:
    """The profiled slice of a traced run."""

    def __init__(self, device_events: List[Tuple[str, str, int, int, bool]],
                 host_events: List[Tuple[str, int, int]], images: int):
        """``device_events``: (name, activity, start, end, launched here);
        ``host_events``: (name, start, end); ``images``: those the slice's
        batches expand."""
        own = [e for e in device_events if e[4]]
        self.images = images
        self.lo = min(e[2] for e in own)
        self.hi = max(e[3] for e in device_events)
        self.device = [e for e in device_events if e[3] > self.lo]
        self.kernels = [e for e in own if e[1] == "kernel"]
        self.host = host_events
        spans = [(e[2], e[3]) for e in self.device]
        self.wall_s = (self.hi - self.lo) / 1e9
        self.busy_s = busy_ns(spans, self.lo, self.hi) / 1e9
        self.gaps = gaps(spans, self.lo, self.hi)

    def kernel_seconds(self, patterns: Sequence[str]) -> float:
        """Device seconds of the slice's own kernels whose lower-cased name
        holds one of ``patterns``."""
        pats = [p.lower() for p in patterns]
        return sum(e[3] - e[2] for e in self.kernels
                   if any(p in e[0].lower() for p in pats)) / 1e9

    def by_category(self) -> Dict[str, float]:
        out: Dict[str, float] = collections.defaultdict(float)
        for e in self.kernels:
            out[category(e[0])] += (e[3] - e[2]) / 1e9
        return dict(out)

    def breakdown(self, n: int = 10) -> dict:
        by_name: Dict[str, float] = collections.defaultdict(float)
        for e in self.kernels:
            by_name[f"{category(e[0])}: {e[0][:120]}"] += (e[3] - e[2]) / 1e9
        idle: Dict[str, float] = collections.defaultdict(float)
        count: Dict[str, int] = collections.Counter()
        for (a, b), label in zip(self.gaps, label_gaps(self.gaps, self.host)):
            idle[label] += (b - a) / 1e9
            count[label] += 1
        return {"device_ops": top(by_name, n),
                "idle_gaps": [[f"{k} ({count[k]} gaps)", v] for k, v in top(idle, n)]}


def activity(e) -> str:
    """The kineto activity of a profiler event, from the event where it says,
    else from its device and name."""
    if hasattr(e, "activity_type"):
        return str(e.activity_type())
    name = e.name()
    if "cuda" in str(e.device_type()).lower():
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        if name.startswith("portbench.") or getattr(e, "is_user_annotation", bool)():
            return "gpu_user_annotation"
        return "kernel"
    if name.startswith(("cuda", "cu")) and not name.startswith("cudnn"):
        return "cuda_runtime"
    return "cpu_op"


def from_profiler(prof, images: int) -> Optional[Slice]:
    """A ``Slice`` of a stopped ``torch.profiler.profile``; None when it
    recorded no device activity."""
    dev, host, launched = [], [], set()
    raw = [(e, activity(e)) for e in prof.profiler.kineto_results.events()]
    for e, act in raw:
        if act in ("cuda_runtime", "cuda_driver") and any(
                k in e.name() for k in ("aunch", "emcpy", "emset")):
            launched.add(e.correlation_id())
    for e, act in raw:
        if act in DEVICE_ACTIVITIES:
            # without launch records every device activity counts as the slice's
            own = (not launched or e.correlation_id() in launched
                   or e.linked_correlation_id() in launched)
            dev.append((e.name(), act, e.start_ns(), e.start_ns() + e.duration_ns(), own))
        elif act in HOST_ACTIVITIES or act == "cuda_runtime":
            host.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    if not any(d[1] == "kernel" and d[4] for d in dev):
        return None
    sl = Slice(dev, host, images)
    sl.note = (f"{len(raw)} events, {len(dev)} on the device, {len(launched)} launch records, "
               f"{len(sl.kernels)} of the slice's own kernels")
    return sl

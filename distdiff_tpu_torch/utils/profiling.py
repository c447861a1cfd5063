"""Profiling helpers (port of ``distdiff_tpu/utils/profiling.py``): a phase
timer that reports a breakdown, ``torch.profiler`` trace capture, and the
CUDA caching allocator's memory counters."""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch


class PhaseTimer:
    """Accumulates wall-clock seconds per named phase; with ``sync`` each
    phase ends with ``torch.cuda.synchronize()`` where a card is in use."""

    def __init__(self, sync: bool = True):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.sync = sync

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = []
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(
                f"{name:<24s} {t:8.3f}s {100 * t / total:5.1f}% "
                f"({self.counts[name]}x, {t / max(self.counts[name], 1):.4f}s avg)"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace the block with ``torch.profiler`` (host, and the card where
    one is present) and write a Chrome trace, ``{log_dir}/trace.json``
    (viewable in Perfetto), when ``log_dir`` is set; no-op otherwise."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per card, the bytes the allocator holds now and at its peak, under
    the JAX version's keys (``bytes_in_use``, ``peak_bytes_in_use``); empty
    without a card."""
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[str(torch.device("cuda", i))] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", -1),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", -1),
        }
    return out

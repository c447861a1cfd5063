"""Train-loop metering (port of ``distdiff_tpu/utils/meters.py``; reference
``utils/misc.py:14-38`` semantics)."""

from __future__ import annotations

import time


class AverageMeter:
    """Tracks the current value, running average, sum and count."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class Stopwatch:
    """Seconds between laps."""

    def __init__(self):
        self._start = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        dt = now - self._start
        self._start = now
        return dt

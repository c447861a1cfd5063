"""Tab-separated training logger (port of ``distdiff_tpu/utils/logger.py``):
the reference's ``utils/logger.py:21-84`` on-disk format (a named column
header line, one tab-separated ``%.6f`` row per append, resume mode
re-reading the existing columns), so tooling that parses ``log.txt`` reads
both packages' runs. Plotting imports matplotlib only when called: the
machine with the card has none."""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence


class Logger:
    def __init__(self, fpath: str, title: Optional[str] = None, resume: bool = False):
        self.file = None
        self.resume = resume
        self.title = "" if title is None else title
        self.names: List[str] = []
        self.numbers: Dict[str, List[float]] = {}
        if fpath is not None:
            if resume and os.path.exists(fpath):
                with open(fpath, "r") as f:
                    name_line = f.readline()
                    self.names = name_line.rstrip().split("\t")
                    self.numbers = {n: [] for n in self.names}
                    for line in f:
                        vals = line.rstrip().split("\t")
                        for i, n in enumerate(self.names):
                            self.numbers[n].append(float(vals[i]))
                self.file = open(fpath, "a")
            else:
                self.file = open(fpath, "w")

    def set_names(self, names: Sequence[str]) -> None:
        if self.resume and self.names:
            return
        self.names = list(names)
        self.numbers = {n: [] for n in self.names}
        self.file.write("\t".join(self.names) + "\n")
        self.file.flush()

    def append(self, numbers: Sequence[float]) -> None:
        if len(self.names) != len(numbers):
            raise ValueError(f"{len(numbers)} numbers for {len(self.names)} names")
        row = []
        for name, num in zip(self.names, numbers):
            row.append(f"{num:.6f}")
            self.numbers[name].append(float(num))
        self.file.write("\t".join(row) + "\n")
        self.file.flush()

    def plot(self, names: Optional[Sequence[str]] = None):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        names = list(names) if names else self.names
        for name in names:
            xs = range(len(self.numbers[name]))
            plt.plot(xs, self.numbers[name])
        plt.legend([f"{self.title}({n})" for n in names])
        plt.grid(True)
        return plt

    def savefig(self, fname: str, dpi: int = 150) -> None:
        plt = self.plot()
        plt.savefig(fname, dpi=dpi)
        plt.close()

    def close(self) -> None:
        if self.file is not None:
            self.file.close()
            self.file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def plot_overlap(logger: "Logger", names: Optional[Sequence[str]] = None):
    """Overlay one logger's series onto the CURRENT matplotlib figure and
    return the legend labels (reference ``utils/logger.py:14-19``) — the
    building block :class:`LoggerMonitor` uses to compare runs."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names = list(names) if names else logger.names
    for name in names:
        xs = range(len(logger.numbers[name]))
        plt.plot(xs, logger.numbers[name])
    return [f"{logger.title}({n})" for n in names]


class LoggerMonitor:
    """Load several ``log.txt`` files and plot them on one set of axes
    (reference ``utils/logger.py:86-102``): ``paths`` is a ``{title:
    filepath}`` dict; each file is opened in resume mode (read-only replay
    of its rows)."""

    def __init__(self, paths: Dict[str, str]):
        self.loggers = [Logger(p, title=t, resume=True) for t, p in paths.items()]
        for lg in self.loggers:  # monitor never appends — close the handles
            lg.close()

    def plot(self, names: Optional[Sequence[str]] = None):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure()
        legend = []
        for lg in self.loggers:
            legend += plot_overlap(lg, names)
        plt.legend(legend, bbox_to_anchor=(1.05, 1), loc=2, borderaxespad=0.0)
        plt.grid(True)
        return plt

    def savefig(self, fname: str, names: Optional[Sequence[str]] = None,
                dpi: int = 150) -> None:
        plt = self.plot(names)
        plt.savefig(fname, dpi=dpi, bbox_inches="tight")
        plt.close()

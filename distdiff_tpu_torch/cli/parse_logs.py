"""Aggregate multi-seed results (port of ``distdiff_tpu/cli/parse_logs.py``;
the reference's ``parse_logs.py``): read ``results.yaml``'s
``best_accuracy`` across seed directories and print mean ± std
(``parse_logs.py:21-66``); a directory without one falls back to the
legacy ``log.txt`` line ``The best performance:<float>``
(``parse_logs.py:12-19``). ``results.yaml`` is read without PyYAML, which
the card's machine lacks: it is the flat ``key: float`` mapping the
trainers of both packages write.

Usage:
  python -m distdiff_tpu_torch.cli.parse_logs checkpoint/caltech-101/resnet50_lr0.1 --multi
"""

from __future__ import annotations

import argparse
import os
import re
from typing import Dict, List, Optional

import numpy as np

_LEGACY_RE = re.compile(r"The best performance:(\d+\.?\d*)")
_YAML_SPECIAL = {".nan": float("nan"), ".inf": float("inf"), "-.inf": float("-inf")}


def extract_performance(log_path: str) -> Optional[float]:
    try:
        with open(log_path) as f:
            matches = _LEGACY_RE.findall(f.read())
        return float(matches[-1]) if matches else None
    except OSError:
        return None


def read_results(path: str) -> Dict[str, float]:
    """A ``results.yaml`` of ``key: float`` lines; a line of another form
    raises."""
    out = {}
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            key, sep, value = line.partition(":")
            value = value.strip().lower()
            if not sep or not key or key != key.strip():
                raise ValueError(f"{path}: {line.rstrip()!r} is not a 'key: float' line")
            out[key] = _YAML_SPECIAL[value] if value in _YAML_SPECIAL else float(value)
    return out


def collect(exp_dir: str, multi: bool) -> List[float]:
    perfs: List[float] = []
    if not os.path.isdir(exp_dir):
        return perfs
    dirs = (
        [os.path.join(exp_dir, d) for d in sorted(os.listdir(exp_dir))
         if os.path.isdir(os.path.join(exp_dir, d))]
        if multi else [exp_dir]
    )
    for d in dirs:
        ry = os.path.join(d, "results.yaml")
        if os.path.exists(ry):
            data = read_results(ry)
            if "best_accuracy" in data:
                perfs.append(float(data["best_accuracy"]))
                continue
        legacy = extract_performance(os.path.join(d, "log.txt"))
        if legacy is not None:
            perfs.append(legacy)
    return perfs


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("exp", type=str)
    p.add_argument("--multi", action="store_true",
                   help="aggregate over seed subdirectories")
    args = p.parse_args(argv)

    perfs = collect(args.exp, args.multi)
    if perfs:
        print(
            f"Average  of {len(perfs)} files is "
            f"{np.mean(perfs):.2f} +- {np.std(perfs):.2f}"
        )
    else:
        print("No valid performances found in the specified directory.")
    return perfs


if __name__ == "__main__":
    main()

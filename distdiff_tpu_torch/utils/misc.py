"""Misc helpers (port of ``distdiff_tpu/utils/misc.py``; reference
``utils/misc.py`` / ``utils/utils.py`` roles)."""

from __future__ import annotations

import os

import numpy as np
import torch


def mkdir_p(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


def count_param(module: torch.nn.Module) -> int:
    """Total parameter count of a module (``utils/utils.py`` count_param)."""
    return sum(p.numel() for p in module.parameters())


def get_mean_and_std(dataset, max_items: int = 5000):
    """Per-channel mean/std over a dataset of HWC arrays
    (``utils/misc.py:get_mean_and_std``)."""
    acc = np.zeros(3, np.float64)
    acc2 = np.zeros(3, np.float64)
    n = 0
    for i in range(min(len(dataset), max_items)):
        img, _ = dataset[i]
        arr = np.asarray(img, np.float64).reshape(-1, 3)
        acc += arr.mean(0)
        acc2 += (arr**2).mean(0)
        n += 1
    mean = acc / n
    std = np.sqrt(acc2 / n - mean**2)
    return mean.astype(np.float32), std.astype(np.float32)

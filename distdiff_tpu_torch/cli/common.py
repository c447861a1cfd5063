"""Shared CLI plumbing for the port's entry points (port of
``distdiff_tpu/cli/common.py``)."""

from __future__ import annotations

import argparse
import logging
import os
import random
from typing import Optional

import numpy as np
import torch

from distdiff_tpu_torch.device import resolve_device


def setup_logging(verbosity: int = logging.INFO) -> None:
    logging.basicConfig(format="%(asctime)s %(levelname)s %(name)s: %(message)s",
                        level=verbosity)


def cli_device() -> torch.device:
    """The device an entry point runs on: the card, unless
    ``DISTDIFF_PLATFORM=cpu`` asks for the CPU (the counterpart of the JAX
    package's ``maybe_force_platform``). With the variable unset and no
    card, it raises."""
    platform = os.environ.get("DISTDIFF_PLATFORM") or "cuda"
    if platform not in ("cpu", "cuda"):
        raise ValueError(f"DISTDIFF_PLATFORM={platform!r}: the port runs on 'cuda' "
                         "(the default) or 'cpu'")
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; set DISTDIFF_PLATFORM=cpu to run "
                           "on the CPU (with --tiny, the toy config)")
    return resolve_device(platform)


def set_seed(seed: Optional[int]) -> None:
    """Seed Python's, numpy's and torch's generators and the per-item data
    augmentation seed."""
    if seed is None:
        return
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    from distdiff_tpu_torch.data.datasets import set_data_seed

    set_data_seed(seed)


def add_dataset_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dataset", "-d", type=str, default="caltech-101")
    p.add_argument("--data_root", type=str, default="./data",
                   help="dataset root (reference convention ./data/{dataset})")

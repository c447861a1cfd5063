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


def add_train_args(p: argparse.ArgumentParser) -> None:
    """The trainer flag vocabulary (reference ``train.py:33-78``)."""
    p.add_argument("--arch", "-a", type=str, default="resnet50")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", "--learning-rate", type=float, default=0.1)
    p.add_argument("--train-batch", type=int, default=64)
    p.add_argument("--test-batch", type=int, default=100)
    p.add_argument("--weight-decay", "--wd", type=float, default=5e-4)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--checkpoint", "-c", type=str, default="checkpoint")
    p.add_argument("--resume", type=str, default="")
    p.add_argument("--evaluate", "-e", action="store_true")
    p.add_argument("--manualSeed", type=int, default=None)
    p.add_argument("--pretrained", action="store_true")
    p.add_argument("--train_fc", action="store_true")
    p.add_argument("--accumulate", type=int, default=1)
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--encoder_weight_path", type=str, default=None)


def ensure_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path

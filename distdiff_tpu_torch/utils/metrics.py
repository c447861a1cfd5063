"""Evaluation metrics (port of ``distdiff_tpu/utils/metrics.py``; reference
``utils/eval.py:5-18``)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def accuracy(logits: torch.Tensor, targets: torch.Tensor,
             topk: Sequence[int] = (1,)) -> Tuple[torch.Tensor, ...]:
    """Top-k precision (in percent) on a batch of logits. Ties rank by
    index, as the JAX package's stable ``argsort`` ranks them."""
    pred = torch.argsort(-logits, dim=-1, stable=True)[:, :max(topk)]
    correct = pred == targets[:, None]
    return tuple(100.0 * correct[:, :k].any(-1).float().mean() for k in topk)

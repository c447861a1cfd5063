"""CutMix (port of ``distdiff_tpu/train/augment/cutmix.py``; the reference
imports the ildoonet/cutmix package, ``train_transform.py:34-35``): paste a
random box from a partner image, soft targets weighted by area."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def rand_bbox(h: int, w: int, lam: float, rng) -> Tuple[int, int, int, int]:
    cut_rat = np.sqrt(1.0 - lam)
    cut_h, cut_w = int(h * cut_rat), int(w * cut_rat)
    cy, cx = int(rng.integers(h)), int(rng.integers(w))
    y1, y2 = np.clip([cy - cut_h // 2, cy + cut_h // 2], 0, h)
    x1, x2 = np.clip([cx - cut_w // 2, cx + cut_w // 2], 0, w)
    return int(y1), int(y2), int(x1), int(x2)


def cutmix_data(
    images: np.ndarray, targets: np.ndarray, beta: float = 1.0, rng=None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """Returns (mixed images, targets_a, targets_b, lam) with lam corrected
    to the actual pasted area."""
    rng = rng or np.random.default_rng()
    lam = float(rng.beta(beta, beta))
    perm = rng.permutation(len(images))
    h, w = images.shape[1:3]
    y1, y2, x1, x2 = rand_bbox(h, w, lam, rng)
    mixed = images.copy()
    mixed[:, y1:y2, x1:x2] = images[perm][:, y1:y2, x1:x2]
    lam = 1.0 - ((y2 - y1) * (x2 - x1) / (h * w))
    return mixed, targets, targets[perm], lam


def soft_target_cross_entropy(logits: torch.Tensor, targets_a: torch.Tensor,
                              targets_b: torch.Tensor, lam: float,
                              mask: torch.Tensor) -> torch.Tensor:
    """CutMixCrossEntropyLoss equivalent (soft one-hot mixture)."""
    n_cls = logits.shape[-1]
    soft = (lam * F.one_hot(targets_a.long(), n_cls).float()
            + (1 - lam) * F.one_hot(targets_b.long(), n_cls).float())
    ll = (soft * F.log_softmax(logits.float(), -1)).sum(-1)
    w = mask.float()
    return -(ll * w).sum() / w.sum().clamp_min(1.0)

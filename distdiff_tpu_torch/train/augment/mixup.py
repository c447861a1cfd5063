"""Mixup (port of ``distdiff_tpu/train/augment/mixup.py``; reference
``augmentations/mixup.py``): beta-lambda convex batch combination and the
paired criterion."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def mixup_data(
    images: np.ndarray, targets: np.ndarray, alpha: float = 1.0,
    rng=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    rng = rng or np.random.default_rng()
    lam = float(rng.beta(alpha, alpha)) if alpha > 0 else 1.0
    perm = rng.permutation(len(images))
    mixed = lam * images + (1 - lam) * images[perm]
    return mixed.astype(images.dtype), targets, targets[perm], lam


def mixup_criterion(ce_fn, logits, targets_a, targets_b, lam, mask):
    return lam * ce_fn(logits, targets_a, mask) + (1 - lam) * ce_fn(
        logits, targets_b, mask
    )

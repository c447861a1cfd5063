"""AugMix (port of ``distdiff_tpu/train/augment/augmix.py``; reference
``augmentations/augment_and_mix.py``): Dirichlet-weighted mixture of
augmentation chains and a Beta skip connection, the 3-view dataset wrapper
feeding the JSD consistency loss (``train_transform.py:259-271``), and
that loss on torch tensors."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from distdiff_tpu_torch.train.augment.pil_ops import AUGMENTATIONS


def augment_and_mix(
    image: np.ndarray,
    to_array: Callable,           # uint8 array -> normalized float array
    severity: int = 3,
    width: int = 3,
    depth: int = -1,
    alpha: float = 1.0,
    rng=None,
) -> np.ndarray:
    r = rng if rng is not None else np.random.default_rng(
        np.random.randint(2**31)
    )
    ws = np.float32(r.dirichlet([alpha] * width))
    m = np.float32(r.beta(alpha, alpha))

    mix = np.zeros_like(to_array(image), np.float32)
    for i in range(width):
        image_aug = image.copy()
        d = depth if depth > 0 else int(r.integers(1, 4))
        for _ in range(d):
            op = AUGMENTATIONS[int(r.integers(len(AUGMENTATIONS)))]
            image_aug = op(image_aug, severity, rng=r)
        mix += ws[i] * to_array(image_aug)
    return (1 - m) * to_array(image) + m * mix


class AugMixDataset:
    """Returns ((clean, augmix1, augmix2), target) triples for the JSD loss."""

    def __init__(self, dataset, pil_stage: Callable, array_stage: Callable,
                 k: int = 3, severity: int = 3, seed: int = 0):
        """``pil_stage``: the geometric transform giving the uint8 crop
        (``fn(image, rng)``); ``array_stage``: uint8 -> normalized array.
        The base ``dataset`` must yield raw uint8 images (its transform
        None)."""
        self.dataset = dataset
        self.pil_stage = pil_stage
        self.array_stage = array_stage
        self.severity = severity
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        img, target = self.dataset[idx]
        rng = np.random.default_rng((self.seed, self.epoch, idx))
        img = self.pil_stage(img, rng)
        clean = self.array_stage(img)
        a1 = augment_and_mix(img, self.array_stage, self.severity, rng=rng)
        a2 = augment_and_mix(img, self.array_stage, self.severity, rng=rng)
        return np.stack([clean, a1, a2]), target


def jsd_consistency_loss(logits_clean: torch.Tensor, logits_a1: torch.Tensor,
                         logits_a2: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Jensen-Shannon divergence across the three views
    (``train_transform.py:388-406``), the masked mean over the rows."""
    p_c = torch.softmax(logits_clean.float(), -1)
    p_1 = torch.softmax(logits_a1.float(), -1)
    p_2 = torch.softmax(logits_a2.float(), -1)
    p_m = torch.clamp((p_c + p_1 + p_2) / 3.0, 1e-7, 1.0)
    log_pm = torch.log(p_m)

    def kl(p):
        return (p * (torch.log(torch.clamp(p, 1e-7, 1.0)) - log_pm)).sum(-1)

    js = (kl(p_c) + kl(p_1) + kl(p_2)) / 3.0
    w = mask.float()
    return (js * w).sum() / w.sum().clamp_min(1.0)

"""Prototype extraction (port of ``distdiff_tpu/prototypes/extract.py``):
guide features -> per-class global prototypes (class means) and local
prototypes (the means of K average-linkage clusters).

The features come from the port's guide on the device; the clustering runs
on the host in numpy, as in the reference. ``load_prototypes`` re-normalises
both arrays, as the reference does on load.
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, Tuple, Union

import numpy as np
import torch

from distdiff_tpu_torch.prototypes.cluster import agglomerative_average


@torch.no_grad()
def extract_features(encode_fn: Callable[[torch.Tensor], torch.Tensor],
                     batches: Iterable[Tuple[np.ndarray, np.ndarray]],
                     device: Union[str, torch.device, None] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Run ``encode_fn`` (e.g. the guide's ``encode_image``) over (images
    ``[B, S, S, 3]``, labels) batches, the images moved to ``device``.
    Returns (features ``[N, D]`` L2-normalised fp32, labels ``[N]``)."""
    feats, labels = [], []
    for images, targets in batches:
        f = encode_fn(torch.as_tensor(images, device=device)).float().cpu().numpy()
        feats.append(f / (np.linalg.norm(f, axis=-1, keepdims=True) + 1e-12))
        labels.append(np.asarray(targets))
    return np.concatenate(feats, 0), np.concatenate(labels, 0)


def build_prototypes(features: np.ndarray, labels: np.ndarray, num_classes: int,
                     k: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """(global ``[C, D]``, local ``[C, K, D]``). A class with fewer than K
    samples repeats its cluster means, so that the shape stays fixed; a
    class with none stays zero."""
    d = features.shape[1]
    global_p = np.zeros((num_classes, d), np.float32)
    local_p = np.zeros((num_classes, k, d), np.float32)
    for c in range(num_classes):
        cls = features[labels == c]
        if len(cls) == 0:
            continue
        global_p[c] = cls.mean(0)
        cluster_labels = agglomerative_average(cls, min(k, len(cls)))
        means = [cls[cluster_labels == li].mean(0) for li in range(cluster_labels.max() + 1)]
        for ki in range(k):
            local_p[c, ki] = means[ki % len(means)]
    return global_p, local_p


def normalize_prototypes(global_p: np.ndarray, local_p: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Row-normalise both arrays (the reference's load-time behaviour)."""
    g = global_p / (np.linalg.norm(global_p, axis=-1, keepdims=True) + 1e-12)
    loc = local_p / (np.linalg.norm(local_p, axis=-1, keepdims=True) + 1e-12)
    return g.astype(np.float32), loc.astype(np.float32)


def save_prototypes(path: str, global_p: np.ndarray, local_p: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, global_prototypes=global_p, local_prototypes=local_p)


def load_prototypes(path: str) -> Tuple[np.ndarray, np.ndarray]:
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    return normalize_prototypes(data["global_prototypes"], data["local_prototypes"])


"""Hierarchical prototype energy (port of
``distdiff_tpu/guidance/energy.py``), in fp32:

  E_b = gs * ||f_b - G[y_b]||
      + ls * ||f_b - L[y_b, argmax_k <f_b, L[y_b,k]>]||

The prototypes are constants (detached); the local prototype is chosen by the
largest dot product, and the gradient flows through the features only.
"""

from __future__ import annotations

from typing import Optional

import torch


def global_energy_per_sample(features, targets, global_protos) -> torch.Tensor:
    proto = global_protos[targets].detach()
    return torch.linalg.vector_norm(features - proto, dim=-1)


def local_energy_per_sample(features, targets, local_protos) -> torch.Tensor:
    protos = local_protos[targets]                        # [B, K, D]
    sims = torch.einsum("bd,bkd->bk", features, protos)
    idx = sims.argmax(dim=-1)
    chosen = protos[torch.arange(protos.shape[0], device=protos.device), idx].detach()
    return torch.linalg.vector_norm(features - chosen, dim=-1)


def hierarchical_energy_per_sample(
    features: torch.Tensor,
    targets: torch.Tensor,
    global_protos: Optional[torch.Tensor],
    local_protos: Optional[torch.Tensor],
    gs: float = 1.0,
    ls: float = 1.0,
) -> torch.Tensor:
    """Per-sample energies ``[B]`` (fp32)."""
    f32 = features.float()
    score = torch.zeros(features.shape[0], dtype=torch.float32, device=features.device)
    if global_protos is not None:
        score = score + gs * global_energy_per_sample(f32, targets, global_protos)
    if local_protos is not None:
        score = score + ls * local_energy_per_sample(f32, targets, local_protos)
    return score


def global_energy(features, targets, global_protos) -> torch.Tensor:
    """The batch mean of ``global_energy_per_sample``."""
    return global_energy_per_sample(features.float(), targets, global_protos).mean()


def local_energy(features, targets, local_protos) -> torch.Tensor:
    """The batch mean of ``local_energy_per_sample``."""
    return local_energy_per_sample(features.float(), targets, local_protos).mean()


def hierarchical_energy(
    features: torch.Tensor,
    targets: torch.Tensor,
    global_protos: Optional[torch.Tensor],
    local_protos: Optional[torch.Tensor],
    gs: float = 1.0,
    ls: float = 1.0,
) -> torch.Tensor:
    """The batch-mean scalar energy (the reference's reduction)."""
    return hierarchical_energy_per_sample(features, targets, global_protos, local_protos,
                                          gs, ls).mean()


def normalize(features: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2 row-normalisation (direct guidance only)."""
    return features / (torch.linalg.vector_norm(features, dim=-1, keepdim=True) + eps)

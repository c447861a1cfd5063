"""Conditioning helpers (port of ``distdiff_tpu/sampling/conditioning.py``)
for SD-1.x's bare text-context tensors ``[B, T, D]``; the leading axis is
the batch axis. SDXL's ``{"ctx", "add"}`` pairs wait for SDXL."""

from __future__ import annotations

from typing import Sequence

import torch


def cond_concat(uncond: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    """CFG pair: [uncond ; cond] along the batch axis."""
    return torch.cat([uncond, cond], dim=0)


def cond_slice(cond: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Batch-axis slice (host-side chunking)."""
    return cond[lo:hi]


def cond_stack(items: Sequence) -> torch.Tensor:
    """Stack per-item conds (tensors or arrays) into one batch."""
    return torch.stack([torch.as_tensor(x) for x in items])

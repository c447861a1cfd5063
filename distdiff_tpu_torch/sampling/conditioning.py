"""Conditioning helpers (port of ``distdiff_tpu/sampling/conditioning.py``)
for SD-1.x's bare text-context tensors ``[B, T, D]``; the leading axis is
the batch axis."""

from __future__ import annotations

import torch


def cond_concat(uncond: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    """CFG pair: [uncond ; cond] along the batch axis."""
    return torch.cat([uncond, cond], dim=0)

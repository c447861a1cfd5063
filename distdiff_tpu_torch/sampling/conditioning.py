"""Conditioning helpers (port of ``distdiff_tpu/sampling/conditioning.py``).

SD-1.x and SD-2.x condition the UNet on one text-context tensor ``[B, T,
D]``; SDXL on two, held as ``{"ctx": [B, T, 2048], "add": [B, 2816]}`` (the
dual-tower context and the additive [pooled | time-id] vector). Every caller
treats a conditioning value as opaque: these functions apply to a tensor
(or numpy array), or to each value of such a dict, with the batch as the
leading axis of each.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch


def cond_map(fn: Callable, *conds: Any) -> Any:
    """``fn`` over a tensor, or key by key over dicts of tensors (the
    dicts of ``conds`` share their keys)."""
    if isinstance(conds[0], dict):
        return {k: fn(*(c[k] for c in conds)) for k in conds[0]}
    return fn(*conds)


def cond_concat(uncond: Any, cond: Any) -> Any:
    """CFG pair: [uncond ; cond] along the batch axis."""
    return cond_map(lambda u, c: torch.cat([u, c], dim=0), uncond, cond)


def cond_slice(cond: Any, lo: int, hi: int) -> Any:
    """Batch-axis slice (host-side chunking)."""
    return cond_map(lambda a: a[lo:hi], cond)


def cond_index(cond: Any, idx: int) -> Any:
    """One item along the leading axis (the dataset's lookup)."""
    return cond_map(lambda a: a[idx], cond)


def cond_stack(items: Sequence[Any]) -> Any:
    """Stack per-item conds (tensors, arrays, or dicts of them) into one
    batch of tensors."""
    return cond_map(lambda *xs: torch.stack([torch.as_tensor(x) for x in xs]), *items)


def cond_leading_dim(cond: Any) -> int:
    first = next(iter(cond.values())) if isinstance(cond, dict) else cond
    return first.shape[0]


def cond_asarray(cond: Any) -> Any:
    """The cond as numpy arrays (tensors moved to the host first)."""
    return cond_map(lambda a: a.detach().cpu().numpy() if torch.is_tensor(a)
                    else np.asarray(a), cond)


def cond_to(cond: Any, device) -> Any:
    """The cond on ``device``."""
    return cond_map(lambda a: torch.as_tensor(a).to(device), cond)

"""Attention ops (port of ``distdiff_tpu/ops/attention.py``).

``attention`` takes ``[B, T, H, D]`` tensors and ``attention_hm`` head-major
``[B, H, T, D]`` ones. The dispatch is the reference's, by kv length
(``attention.py:118-130,177-186``): attention over at most 256 kv tokens
(the 77-token cross-attention, the 16^2 and 8^2 self-attention) takes the
plain fp32-softmax path on every device; longer kv on a CUDA tensor takes
the flash kernels (``ops/flash.py``), and on the CPU the plain path.
"""

from __future__ import annotations

import torch

from distdiff_tpu_torch.ops import flash

SMALL_KV = 256


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain attention with an fp32 softmax, ``[B, T, H, D]`` layout."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(logits * scale, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def xla_attention_hm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain attention with an fp32 softmax, head-major ``[B, H, T, D]``."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    probs = torch.softmax(logits * scale, dim=-1)
    return torch.matmul(probs.to(v.dtype), v).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if k.shape[1] > SMALL_KV and q.is_cuda:
        return flash.flash_attention(q, k, v)
    return xla_attention(q, k, v)


def attention_hm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if k.shape[2] > SMALL_KV and q.is_cuda:
        return flash.flash_attention_hm(q, k, v)
    return xla_attention_hm(q, k, v)

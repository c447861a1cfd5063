"""GroupNorm with fp32 statistics (port of ``xla_group_norm`` in
``distdiff_tpu/ops/groupnorm.py``).

Only the plain version is ported: the reference keeps its Pallas GroupNorm
kernels off on its default path (``groupnorm.py:265-286``). Works on NCHW
tensors (the reference is NHWC; the statistics are the same).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float = 1e-5, act: Optional[str] = None
               ) -> torch.Tensor:
    """fp32 per-group mean/variance folded into a per-channel (a, b), cast
    to x's dtype before ``x * a + b``; the optional SiLU runs in fp32."""
    b, c = x.shape[:2]
    cpg = c // groups
    x32 = x.float()
    red = tuple(range(2, x.ndim))
    n = cpg
    for d in x.shape[2:]:
        n *= d
    g1 = x32.sum(dim=red).reshape(b, groups, cpg).sum(-1)
    g2 = (x32 * x32).sum(dim=red).reshape(b, groups, cpg).sum(-1)
    mean_g = g1 / n
    var_g = g2 / n - mean_g * mean_g
    inv_g = torch.rsqrt(var_g + eps)
    mean_c = mean_g.repeat_interleave(cpg, dim=1)
    inv_c = inv_g.repeat_interleave(cpg, dim=1)
    s32 = scale.float()[None, :]
    a = (inv_c * s32).to(x.dtype)
    b_ = (bias.float()[None, :] - mean_c * inv_c * s32).to(x.dtype)
    shape = (b, c) + (1,) * (x.ndim - 2)
    y = x * a.reshape(shape) + b_.reshape(shape)
    if act is None:
        return y
    if act == "silu":
        return F.silu(y.float()).to(y.dtype)
    raise ValueError(f"unsupported groupnorm activation {act!r}")

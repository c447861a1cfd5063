"""Plain fp32 building blocks of the reference UNet and VAE.

Module and parameter names are diffusers' (``norm1``, ``conv1``,
``time_emb_proj``, ``attn1.to_q``, ``ff.net.0.proj``, ...), so a diffusers
state dict loads with a strict ``load_state_dict``. Everything computes in
float32 with plain ``torch`` operations: attention is softmax(q k^T / sqrt(d))
v written out, GroupNorm is ``F.group_norm``. Tensors are NCHW.

Departures from diffusers, each to compute the function of the system under
test (the DistDiff recipe as its JAX original defines it): LayerNorm eps 1e-6
(flax's default; diffusers 1e-5), GroupNorm eps 1e-5 in the VAE too
(diffusers 1e-6), the feed-forward's GEGLU gate through the tanh
approximation of GELU (flax's ``nn.gelu``; diffusers the exact erf form).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

GN_EPS = 1e-5
LN_EPS = 1e-6
# rounding of the attention products' operands: None (fp32) but in the
# low-precision control (``reference/lowp.py``)
OPERAND_ROUNDING = None


def groups_of(c: int, num_groups: int = 32) -> int:
    """min(32, c), then down to the largest divisor of c."""
    g = min(num_groups, c)
    while c % g:
        g -= 1
    return g


def blockwise(remat: bool, module: nn.Module, *args):
    """``module(*args)``; with ``remat``, while autograd records, under a
    checkpoint, so the backward keeps the block's input and not its insides
    (the values are the same)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(module, *args, use_reentrant=False)
    return module(*args)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding ``[cos | sin]`` (diffusers' flip_sin_to_cos,
    freq_shift 0), fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class GroupNorm(nn.GroupNorm):
    def __init__(self, c: int, silu: bool = False):
        super().__init__(groups_of(c), c, eps=GN_EPS)
        self.silu = silu

    def forward(self, x):
        y = super().forward(x)
        return F.silu(y) if self.silu else y


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, temb: int = None):
        super().__init__()
        self.norm1 = GroupNorm(cin, silu=True)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb, cout) if temb else None
        self.norm2 = GroupNorm(cout, silu=True)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x))
        if self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        return h + (x if self.conv_shortcut is None else self.conv_shortcut(x))


class Downsample2D(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


def attend(q, k, v):
    """softmax(q k^T / sqrt(d)) v over ``[B, H, T, D]``, written out."""
    r = OPERAND_ROUNDING or (lambda x: x)
    w = torch.matmul(r(q), r(k).transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return torch.matmul(r(torch.softmax(w, dim=-1)), r(v))


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int = None):
        super().__init__()
        context_dim = context_dim or dim
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(context_dim, dim, bias=False)
        self.to_v = nn.Linear(context_dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x, context=None):
        ctx = x if context is None else context
        b, t, c = x.shape
        h = self.heads

        def heads(y):
            return y.view(b, -1, h, c // h).transpose(1, 2)

        out = attend(heads(self.to_q(x)), heads(self.to_k(ctx)), heads(self.to_v(ctx)))
        return self.to_out[0](out.transpose(1, 2).reshape(b, t, c))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn1 = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn2 = Attention(dim, heads, context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    """GroupNorm, proj_in, transformer blocks over the HW tokens, proj_out,
    residual. proj_in/proj_out are 1x1 convolutions, or linear layers on the
    tokens under diffusers' ``use_linear_projection``."""

    def __init__(self, c: int, heads: int, context_dim: int, depth: int, linear: bool):
        super().__init__()
        self.linear = linear
        self.norm = GroupNorm(c)
        self.proj_in = nn.Linear(c, c) if linear else nn.Conv2d(c, c, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(c, heads, context_dim) for _ in range(depth)])
        self.proj_out = nn.Linear(c, c) if linear else nn.Conv2d(c, c, 1)

    def forward(self, x, context):
        b, c, h, w = x.shape
        y = self.norm(x)
        if not self.linear:
            y = self.proj_in(y)
        y = y.flatten(2).transpose(1, 2)
        if self.linear:
            y = self.proj_in(y)
        for blk in self.transformer_blocks:
            y = blk(y, context)
        if self.linear:
            y = self.proj_out(y)
        y = y.transpose(1, 2).reshape(b, c, h, w)
        if not self.linear:
            y = self.proj_out(y)
        return y + x


class Block(nn.Module):
    """diffusers' down/mid/up block containers: ``resnets``, ``attentions``
    and ``downsamplers`` or ``upsamplers``."""

    def __init__(self, resnets, attentions=(), samplers=None, sampler_name=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        if samplers:
            setattr(self, sampler_name, nn.ModuleList(samplers))


class TimestepEmbedding(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(cin, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))

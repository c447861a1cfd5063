"""Building blocks of the diffusion models (port of
``distdiff_tpu/models/layers.py``).

Module and parameter names are diffusers' (``norm1``, ``conv1``,
``time_emb_proj``, ``attn1.to_q``, ``ff.net.0.proj``, ...) so that a
diffusers checkpoint loads with a strict ``load_state_dict``. Tensors are
NCHW inside the models; the public model calls take the reference's NHWC.

Precision follows the reference: every layer computes in its ``dtype``
(bf16 at SD-1.5 geometry), casting its input and weights to it, as flax's
``nn.Dense(dtype=...)`` promotes; normalisation statistics are fp32; the
timestep MLP is fp32. The layers where the reference has ``QConv`` and
``QDense`` (the resnets' convolutions, the resamplers' and the feed-forward
projections) are ``QConv2d``/``QLinear``: the same layers, taking the int8
route of ``ops/quant.py`` while ``int8_inference()`` is on.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from distdiff_tpu_torch.ops import attention as attn_op
from distdiff_tpu_torch.ops import quant
from distdiff_tpu_torch.ops.groupnorm import group_norm


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding, fp32, ``[cos | sin]`` halves (SD convention)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def group_count(c: int, num_groups: int = 32) -> int:
    """The reference's rule: min(32, c), then down to the largest divisor."""
    groups = min(num_groups, c)
    while c % groups:
        groups -= 1
    return groups


class Linear(nn.Linear):
    """``nn.Dense(dtype=...)``: input, weight and bias cast to ``dtype``."""

    def __init__(self, in_features, out_features, bias=True,
                 dtype=torch.float32, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Conv2d(nn.Conv2d):
    """A convolution computed in ``dtype`` (the reference's ``QConv`` and its
    1x1 convolutions written as ``nn.Dense``)."""

    def __init__(self, cin, cout, kernel_size, stride=1, padding=0,
                 dtype=torch.float32, device=None):
        super().__init__(cin, cout, kernel_size, stride=stride,
                         padding=padding, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        self.stride, self.padding)


class QConv2d(Conv2d):
    """The reference's ``QConv``: a ``Conv2d`` (same parameters and dtype
    numerics) that takes the int8 w8a8 route (``ops/quant.py`` ``qconv``)
    while ``int8_inference()`` is on; the bias is added after, in
    ``dtype``."""

    def forward(self, x):
        if not quant.int8_enabled():
            return super().forward(x)
        dt = self.compute_dtype
        y = quant.qconv(x, self.weight, self.stride, self.padding, out_dtype=dt)
        return y + self.bias.to(dt)[:, None, None]


class QLinear(Linear):
    """The reference's ``QDense``: a ``Linear`` with the same int8 switch
    (``qdot``)."""

    def forward(self, x):
        if not quant.int8_enabled():
            return super().forward(x)
        dt = self.compute_dtype
        y = quant.qdot(x, self.weight, out_dtype=dt)
        return y if self.bias is None else y + self.bias.to(dt)


class SmallConv3x3(nn.Conv2d):
    """The reference's ``SmallConv3x3``: products of ``dtype``-rounded
    operands accumulated in fp32, fp32 bias, result cast to ``out_dtype``
    (default ``dtype``). A plain 3x3 convolution with padding 1."""

    def __init__(self, cin, cout, dtype=torch.float32, out_dtype=None, device=None):
        super().__init__(cin, cout, 3, padding=1, device=device)
        self.compute_dtype = dtype
        self.out_dtype = out_dtype or dtype

    def forward(self, x):
        dt = self.compute_dtype
        y = F.conv2d(x.to(dt).float(), self.weight.to(dt).float(),
                     self.bias.float(), padding=1)
        return y.to(self.out_dtype)


class GroupNorm(nn.Module):
    """GroupNorm with fp32 statistics and an optional fused SiLU."""

    def __init__(self, channels: int, act: Optional[str] = None,
                 eps: float = 1e-5, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.groups = group_count(channels)
        self.eps = eps
        self.act = act

    def forward(self, x):
        return group_norm(x, self.weight, self.bias, self.groups, self.eps, self.act)


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm``: eps 1e-6, fp32 statistics, output in ``dtype``."""

    def __init__(self, dim, dtype=torch.float32, device=None):
        super().__init__(dim, eps=1e-6, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(self.compute_dtype)


class TimestepEmbedding(nn.Module):
    """time_embedding: Linear -> SiLU -> Linear in fp32, output in ``dtype``."""

    def __init__(self, in_dim, dim, dtype=torch.float32, device=None):
        super().__init__()
        self.linear_1 = Linear(in_dim, dim, device=device)
        self.linear_2 = Linear(dim, dim, device=device)
        self.out_dtype = dtype

    def forward(self, emb):
        return self.linear_2(F.silu(self.linear_1(emb))).to(self.out_dtype)


class ResnetBlock2D(nn.Module):
    """GN -> SiLU -> Conv -> (+time) -> GN -> SiLU -> Conv, with skip."""

    def __init__(self, cin, cout, temb_channels=None, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.norm1 = GroupNorm(cin, act="silu", device=device)
        self.conv1 = QConv2d(cin, cout, 3, padding=1, dtype=dtype, device=device)
        if temb_channels is not None:
            self.time_emb_proj = Linear(temb_channels, cout, dtype=dtype, device=device)
        else:
            self.time_emb_proj = None
        self.norm2 = GroupNorm(cout, act="silu", device=device)
        self.conv2 = QConv2d(cout, cout, 3, padding=1, dtype=dtype, device=device)
        self.conv_shortcut = (Conv2d(cin, cout, 1, dtype=dtype, device=device)
                              if cin != cout else None)

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        residual = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return h + residual


class Downsample2D(nn.Module):
    def __init__(self, c, dtype=torch.float32, device=None):
        super().__init__()
        self.conv = QConv2d(c, c, 3, stride=2, padding=1, dtype=dtype, device=device)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, c, dtype=torch.float32, device=None):
        super().__init__()
        self.conv = QConv2d(c, c, 3, padding=1, dtype=dtype, device=device)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Attention(nn.Module):
    """Multi-head attention over tokens ``[B, T, C]``; self-attention when
    ``context`` is None. q/k/v go head-major to ``attention_hm`` (the kernel
    path for kv > 256)."""

    def __init__(self, query_dim, heads, head_dim, context_dim=None,
                 dtype=torch.float32, device=None):
        super().__init__()
        inner = heads * head_dim
        context_dim = context_dim or query_dim
        self.heads = heads
        self.head_dim = head_dim
        self.to_q = Linear(query_dim, inner, bias=False, dtype=dtype, device=device)
        self.to_k = Linear(context_dim, inner, bias=False, dtype=dtype, device=device)
        self.to_v = Linear(context_dim, inner, bias=False, dtype=dtype, device=device)
        self.to_out = nn.ModuleList(
            [Linear(inner, query_dim, dtype=dtype, device=device)])

    def forward(self, x, context=None):
        ctx = x if context is None else context
        b, tq, _ = x.shape
        tk = ctx.shape[1]
        h, d = self.heads, self.head_dim
        q = self.to_q(x).view(b, tq, h, d).transpose(1, 2)
        k = self.to_k(ctx).view(b, tk, h, d).transpose(1, 2)
        v = self.to_v(ctx).view(b, tk, h, d).transpose(1, 2)
        out = attn_op.attention_hm(q, k, v)                 # [B, H, Tq, D]
        out = out.transpose(1, 2).reshape(b, tq, h * d)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim, dim_out, dtype=torch.float32, device=None):
        super().__init__()
        self.proj = QLinear(dim, dim_out * 2, dtype=dtype, device=device)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        # flax nn.gelu is the tanh approximation
        return h * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim, mult=4, dtype=torch.float32, device=None):
        super().__init__()
        # diffusers' layout: net.0 GEGLU, net.1 dropout, net.2 Linear
        self.net = nn.ModuleList([
            GEGLU(dim, dim * mult, dtype=dtype, device=device),
            nn.Identity(),
            QLinear(dim * mult, dim, dtype=dtype, device=device),
        ])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    """LN -> self-attn, LN -> cross-attn, LN -> GEGLU feed-forward."""

    def __init__(self, dim, heads, head_dim, context_dim, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = LayerNorm(dim, **kw)
        self.attn1 = Attention(dim, heads, head_dim, **kw)
        self.norm2 = LayerNorm(dim, **kw)
        self.attn2 = Attention(dim, heads, head_dim, context_dim=context_dim, **kw)
        self.norm3 = LayerNorm(dim, **kw)
        self.ff = FeedForward(dim, **kw)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


def remat_call(remat: bool, module: nn.Module, *args):
    """``module(*args)``, under a non-reentrant ``torch.utils.checkpoint``
    when ``remat`` is set and autograd records (where the JAX package puts
    ``nn.remat``): the backward recomputes the block from its inputs
    instead of keeping its activations. The values are the same."""
    if remat and torch.is_grad_enabled():
        return checkpoint(module, *args, use_reentrant=False)
    return module(*args)


def with_remat(model: nn.Module, remat: bool) -> nn.Module:
    """``model`` (a UNet or an ``AutoencoderKL``, each with a ``config``
    holding ``remat``) with its inner checkpoints set to ``remat``: the
    model itself when they already are, else a shallow copy that shares
    every parameter and submodule and differs in its config alone."""
    if model.config.remat == remat:
        return model
    view = copy.copy(model)
    view.config = dataclasses.replace(model.config, remat=remat)
    return view


class Block(nn.Module):
    """A container named like diffusers' down/mid/up blocks: ``resnets``,
    ``attentions`` (possibly empty) and, when given, ``samplers`` under
    ``sampler_name`` (``downsamplers`` or ``upsamplers``)."""

    def __init__(self, resnets, attentions=(), samplers=None, sampler_name=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        if samplers:
            setattr(self, sampler_name, nn.ModuleList(samplers))


class Transformer2DModel(nn.Module):
    """SpatialTransformer: GN -> proj_in -> blocks over HW tokens ->
    proj_out, residual. The projections are 1x1 convolutions (SD-1.x), or
    with ``linear`` linear layers on the tokens (diffusers'
    ``use_linear_projection``, SD-2.x): the same function, stored as
    [C, C, 1, 1] or [C, C]."""

    def __init__(self, c, heads, head_dim, context_dim, depth=1,
                 dtype=torch.float32, device=None, linear=False):
        super().__init__()
        self.linear = linear
        proj = ((lambda: Linear(c, c, dtype=dtype, device=device)) if linear
                else (lambda: Conv2d(c, c, 1, dtype=dtype, device=device)))
        self.norm = GroupNorm(c, device=device)
        self.proj_in = proj()
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(c, heads, head_dim, context_dim, dtype=dtype,
                                  device=device)
            for _ in range(depth)])
        self.proj_out = proj()

    def forward(self, x, context):
        b, c, h, w = x.shape
        y = self.norm(x)
        if not self.linear:
            y = self.proj_in(y)
        y = y.flatten(2).transpose(1, 2)                    # [B, HW, C]
        if self.linear:
            y = self.proj_in(y)
        for block in self.transformer_blocks:
            y = block(y, context)
        if self.linear:
            y = self.proj_out(y)
        y = y.transpose(1, 2).reshape(b, c, h, w)
        if not self.linear:
            y = self.proj_out(y)
        return y + x

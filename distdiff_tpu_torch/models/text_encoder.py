"""CLIP text transformer, SD's prompt conditioner (port of
``distdiff_tpu/models/text_encoder.py``) with transformers'
``CLIPTextModel`` state-dict names (``text_model.embeddings...``,
``text_model.encoder.layers.{i}.self_attn.q_proj``, ...), so a diffusers
checkpoint's ``text_encoder`` loads with a strict ``load_state_dict``.

The causal attention over 77 tokens is plain ``torch.matmul`` and softmax,
as the reference computes it outside its kernels. Precision follows the
reference: layers compute in the config's dtype, layer norms (eps 1e-6, as
flax's) keep fp32 statistics, the softmax is fp32, and the output is fp32.
SDXL's ``penultimate_hidden`` and ``sdxl_outputs`` wait for SDXL.
"""

from __future__ import annotations

import math
from typing import Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from distdiff_tpu_torch.config import TextEncoderConfig
from distdiff_tpu_torch.device import resolve_device
from distdiff_tpu_torch.models.layers import LayerNorm, Linear


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: TextEncoderConfig, device=None):
        super().__init__()
        d, dt = cfg.hidden_size, cfg.dtype
        self.heads = cfg.num_heads
        self.q_proj = Linear(d, d, dtype=dt, device=device)
        self.k_proj = Linear(d, d, dtype=dt, device=device)
        self.v_proj = Linear(d, d, dtype=dt, device=device)
        self.out_proj = Linear(d, d, dtype=dt, device=device)

    def forward(self, x: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h = self.heads
        q = self.q_proj(x).view(b, t, h, d // h).transpose(1, 2)
        k = self.k_proj(x).view(b, t, h, d // h).transpose(1, 2)
        v = self.v_proj(x).view(b, t, h, d // h).transpose(1, 2)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d // h)
        logits = logits.masked_fill(~causal, -1e30)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, t, d)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, cfg: TextEncoderConfig, device=None):
        super().__init__()
        d, dt = cfg.hidden_size, cfg.dtype
        self.fc1 = Linear(d, d * cfg.mlp_ratio, dtype=dt, device=device)
        self.fc2 = Linear(d * cfg.mlp_ratio, d, dtype=dt, device=device)
        if cfg.activation not in ("quick_gelu", "gelu"):
            raise ValueError(f"unknown text-encoder activation {cfg.activation!r}")
        self.quick = cfg.activation == "quick_gelu"

    def forward(self, x):
        y = self.fc1(x)
        # flax's nn.gelu is the tanh approximation
        y = quick_gelu(y) if self.quick else F.gelu(y, approximate="tanh")
        return self.fc2(y)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: TextEncoderConfig, device=None):
        super().__init__()
        self.layer_norm1 = LayerNorm(cfg.hidden_size, dtype=cfg.dtype, device=device)
        self.self_attn = CLIPAttention(cfg, device=device)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, dtype=cfg.dtype, device=device)
        self.mlp = CLIPMLP(cfg, device=device)

    def forward(self, x, causal):
        x = x + self.self_attn(self.layer_norm1(x), causal)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: TextEncoderConfig, device=None):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device)
        self.position_embedding = nn.Embedding(cfg.max_length, cfg.hidden_size, device=device)


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: TextEncoderConfig, device=None):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg, device=device)
                                     for _ in range(cfg.num_layers)])


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: TextEncoderConfig, device=None):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg, device=device)
        self.encoder = CLIPEncoder(cfg, device=device)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, dtype=cfg.dtype, device=device)


class CLIPTextEncoder(nn.Module):
    """``input_ids [B, T]`` -> the last hidden state ``[B, T, D]`` in fp32,
    the SD conditioning the UNet's cross-attention takes."""

    def __init__(self, config: TextEncoderConfig,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config, device=resolve_device(device))

    def hidden_states(self, input_ids: torch.Tensor) -> torch.Tensor:
        dt = self.config.dtype
        tm = self.text_model
        t = input_ids.shape[1]
        x = tm.embeddings.token_embedding(input_ids).to(dt)
        x = x + tm.embeddings.position_embedding.weight[None, :t].to(dt)
        causal = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
        for layer in tm.encoder.layers:
            x = layer(x, causal)
        return tm.final_layer_norm(x).float()

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.hidden_states(input_ids)

"""CLIP text transformer, SD's prompt conditioner (port of
``distdiff_tpu/models/text_encoder.py``) with transformers'
``CLIPTextModel`` state-dict names (``text_model.embeddings...``,
``text_model.encoder.layers.{i}.self_attn.q_proj``, ...), so a diffusers
checkpoint's ``text_encoder`` loads with a strict ``load_state_dict``.

The causal attention over 77 tokens is plain ``torch.matmul`` and softmax,
as the reference computes it outside its kernels. Precision follows the
reference: layers compute in the config's dtype, layer norms (eps 1e-6, as
flax's) keep fp32 statistics, the softmax is fp32, and the output is fp32.

With ``embed_dim`` set, the module also holds the bias-free
``text_projection`` of transformers' ``CLIPTextModelWithProjection``
(SDXL's ``text_encoder_2``): the pooled embedding is the final hidden state
at the end-of-text token (the highest id, ``argmax(input_ids)``) through it,
in fp32. SDXL conditions on ``penultimate_hidden``, the state after all
blocks but the last, without the final layer norm.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

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
        device = resolve_device(device)
        self.text_model = CLIPTextTransformer(config, device=device)
        if config.embed_dim is not None:
            self.text_projection = Linear(config.hidden_size, config.embed_dim, bias=False,
                                          device=device)

    def _embed(self, input_ids: torch.Tensor):
        dt = self.config.dtype
        tm = self.text_model
        t = input_ids.shape[1]
        x = tm.embeddings.token_embedding(input_ids).to(dt)
        x = x + tm.embeddings.position_embedding.weight[None, :t].to(dt)
        return x, torch.ones((t, t), dtype=torch.bool, device=x.device).tril()

    def _pool(self, h: torch.Tensor, input_ids: torch.Tensor) -> torch.Tensor:
        """The final hidden state at the end-of-text token, projected."""
        if self.config.embed_dim is None:
            raise ValueError("the pooled output needs TextEncoderConfig.embed_dim")
        eot = input_ids.argmax(dim=-1)
        return self.text_projection(h[torch.arange(h.shape[0], device=h.device), eot])

    def hidden_states(self, input_ids: torch.Tensor) -> torch.Tensor:
        x, causal = self._embed(input_ids)
        for layer in self.text_model.encoder.layers:
            x = layer(x, causal)
        return self.text_model.final_layer_norm(x).float()

    def penultimate_hidden(self, input_ids: torch.Tensor) -> torch.Tensor:
        """The state after every block but the last, without the final layer
        norm (diffusers' ``hidden_states[-2]``): SDXL's conditioning tap."""
        x, causal = self._embed(input_ids)
        for layer in self.text_model.encoder.layers[:-1]:
            x = layer(x, causal)
        return x.float()

    def sdxl_outputs(self, input_ids: torch.Tensor
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(``penultimate_hidden`` [B, T, D], the pooled projection [B,
        embed_dim] or None without ``embed_dim``) in one pass."""
        x, causal = self._embed(input_ids)
        layers = self.text_model.encoder.layers
        for layer in layers[:-1]:
            x = layer(x, causal)
        penult = x.float()
        if self.config.embed_dim is None:
            return penult, None
        h = self.text_model.final_layer_norm(layers[-1](x, causal)).float()
        return penult, self._pool(h, input_ids)

    def encode_pooled(self, input_ids: torch.Tensor) -> torch.Tensor:
        """The pooled projection ``[B, embed_dim]`` alone."""
        return self._pool(self.hidden_states(input_ids), input_ids)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.hidden_states(input_ids)

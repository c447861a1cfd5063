"""CLIP ViT-B/32 image tower and the zero-shot head (port of
``distdiff_tpu/models/guide/clip_vit.py``; the reference's
``open_clip_vit_b32`` arch).

``encode_image`` takes NHWC images and returns the projected embedding
``[B, embed_dim]``; ``zero_shot_logits`` is the classifier over
L2-normalised class-template text features. The JAX package is copied
where it departs from open_clip: every LayerNorm has flax's eps 1e-6
(``models/layers.py`` ``LayerNorm``), the MLP is quick_gelu whatever tower
the weights came from, and the zero-shot scale is a fixed 100 with
``+1e-8`` in the norms. The patch embedding is a bias-free convolution with
stride = patch (flax's "SAME" padding adds none when the patch divides the
image); its tokens go row-major over the (gh, gw) grid, the class token
first. ``class_embedding``, ``positional_embedding`` and ``proj`` are fp32
parameters cast to the activation dtype.

State-dict names: ``patch_embed``, ``class_embedding``,
``positional_embedding``, ``ln_pre``, ``resblocks.{i}.{ln_1, q_proj, k_proj,
v_proj, out_proj, ln_2, c_fc, c_proj}``, ``ln_post``, ``proj`` (the JAX
tree's; ``weights/openclip.py`` converts OpenCLIP checkpoints to them).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from distdiff_tpu_torch.models.layers import LayerNorm, Linear
from distdiff_tpu_torch.ops import attention as attn_op


@dataclasses.dataclass(frozen=True)
class CLIPViTConfig:
    image_size: int = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    embed_dim: int = 512  # the projected output's width
    dtype: torch.dtype = torch.float32


def tiny_clip_vit_config() -> CLIPViTConfig:
    return CLIPViTConfig(image_size=32, patch_size=8, width=32, layers=2, heads=2,
                         embed_dim=16)


class ViTBlock(nn.Module):
    def __init__(self, cfg: CLIPViTConfig, device=None):
        super().__init__()
        d, dt = cfg.width, cfg.dtype
        self.heads = cfg.heads
        self.ln_1 = LayerNorm(d, dtype=dt, device=device)
        self.q_proj = Linear(d, d, dtype=dt, device=device)
        self.k_proj = Linear(d, d, dtype=dt, device=device)
        self.v_proj = Linear(d, d, dtype=dt, device=device)
        self.out_proj = Linear(d, d, dtype=dt, device=device)
        self.ln_2 = LayerNorm(d, dtype=dt, device=device)
        self.c_fc = Linear(d, 4 * d, dtype=dt, device=device)
        self.c_proj = Linear(4 * d, d, dtype=dt, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h = self.heads
        y = self.ln_1(x)
        q, k, v = (proj(y).reshape(b, t, h, d // h)
                   for proj in (self.q_proj, self.k_proj, self.v_proj))
        x = x + self.out_proj(attn_op.attention(q, k, v).reshape(b, t, d))
        y = self.c_fc(self.ln_2(x))
        y = y * torch.sigmoid(1.702 * y)  # quick_gelu
        return x + self.c_proj(y)


class CLIPViT(nn.Module):
    # raw parameters drawn from normal(0.02), as the flax module draws them
    # (``models/init.py`` ``init_weights`` reads this)
    NORMAL_PARAMS = ("class_embedding", "positional_embedding", "proj")

    def __init__(self, cfg: CLIPViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        w, p, dt = cfg.width, cfg.patch_size, cfg.dtype
        n_patches = (cfg.image_size // p) ** 2
        self.patch_embed = nn.Conv2d(3, w, p, stride=p, bias=False, device=device)
        self.class_embedding = nn.Parameter(torch.empty(w, device=device))
        self.positional_embedding = nn.Parameter(torch.empty(n_patches + 1, w, device=device))
        self.ln_pre = LayerNorm(w, dtype=dt, device=device)
        self.resblocks = nn.ModuleList([ViTBlock(cfg, device=device)
                                        for _ in range(cfg.layers)])
        self.ln_post = LayerNorm(w, dtype=dt, device=device)
        self.proj = nn.Parameter(torch.empty(w, cfg.embed_dim, device=device))
        with torch.no_grad():
            for name in self.NORMAL_PARAMS:
                getattr(self, name).normal_(std=0.02)
        self.eval()

    def encode_image(self, x: torch.Tensor, pooling: str = "cls") -> torch.Tensor:
        """NHWC images -> the projected class token ``[B, embed_dim]``;
        ``pooling`` is taken for the guides' common signature and unused."""
        del pooling
        dt = self.cfg.dtype
        h = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.patch_embed.weight.to(dt),
                     stride=self.cfg.patch_size).permute(0, 2, 3, 1)
        b, gh, gw, w = h.shape
        h = h.reshape(b, gh * gw, w)
        cls = self.class_embedding.to(h.dtype)[None, None, :].expand(b, 1, w)
        h = torch.cat([cls, h], dim=1) + self.positional_embedding[None].to(h.dtype)
        h = self.ln_pre(h)
        for blk in self.resblocks:
            h = blk(h)
        return self.ln_post(h[:, 0, :]) @ self.proj.to(h.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.encode_image(x)


def zero_shot_logits(image_features: torch.Tensor, class_text_features: torch.Tensor,
                     logit_scale: float = 100.0) -> torch.Tensor:
    """``scale * normalize(img) @ normalize(text).T`` (the reference's
    ``wrap_clip_forward``)."""
    img = image_features / (torch.linalg.vector_norm(image_features, dim=-1, keepdim=True)
                            + 1e-8)
    txt = class_text_features / (
        torch.linalg.vector_norm(class_text_features, dim=-1, keepdim=True) + 1e-8)
    return logit_scale * img @ txt.T

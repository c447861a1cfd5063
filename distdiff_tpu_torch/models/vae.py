"""AutoencoderKL (port of ``distdiff_tpu/models/vae.py``) with diffusers'
state-dict names. Public calls take and return NHWC; inside it runs NCHW.

The decoder is the guidance gradient's path. Its mid-block attention is a
single head of width C (512 at SD geometry) over the latent's 64^2 tokens,
so it reaches the flash kernels at D = 512.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn

from distdiff_tpu_torch.config import VAEConfig
from distdiff_tpu_torch.device import resolve_device
from distdiff_tpu_torch.models.layers import (
    Block,
    Conv2d,
    Downsample2D,
    GroupNorm,
    Linear,
    ResnetBlock2D,
    SmallConv3x3,
    Upsample2D,
)
from distdiff_tpu_torch.ops import attention as attn_op


class VAEAttention(nn.Module):
    """Single-head full self-attention over spatial positions."""

    def __init__(self, c, dtype=torch.float32, device=None):
        super().__init__()
        self.group_norm = GroupNorm(c, device=device)
        self.to_q = Linear(c, c, dtype=dtype, device=device)
        self.to_k = Linear(c, c, dtype=dtype, device=device)
        self.to_v = Linear(c, c, dtype=dtype, device=device)
        self.to_out = nn.ModuleList([Linear(c, c, dtype=dtype, device=device)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).flatten(2).transpose(1, 2)   # [B, HW, C]
        q = self.to_q(y)[:, :, None, :]
        k = self.to_k(y)[:, :, None, :]
        v = self.to_v(y)[:, :, None, :]
        out = attn_op.attention(q, k, v)[:, :, 0, :]
        out = self.to_out[0](out)
        return x + out.transpose(1, 2).reshape(b, c, h, w)


def _mid_block(c, dtype, device):
    return Block(
        [ResnetBlock2D(c, c, dtype=dtype, device=device),
         ResnetBlock2D(c, c, dtype=dtype, device=device)],
        [VAEAttention(c, dtype=dtype, device=device)])


def _run_mid(mid, x):
    x = mid.resnets[0](x)
    x = mid.attentions[0](x)
    return mid.resnets[1](x)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        dt = cfg.dtype
        boc = cfg.block_out_channels
        n = len(boc)
        self.conv_in = SmallConv3x3(cfg.in_channels, boc[0], dtype=dt, device=device)
        x_ch = boc[0]
        blocks = []
        for bi, ch in enumerate(boc):
            resnets = []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(x_ch, ch, dtype=dt, device=device))
                x_ch = ch
            samplers = [Downsample2D(ch, dtype=dt, device=device)] if bi < n - 1 else None
            blocks.append(Block(resnets, (), samplers, "downsamplers"))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _mid_block(boc[-1], dt, device)
        self.conv_norm_out = GroupNorm(boc[-1], act="silu", device=device)
        self.conv_out = SmallConv3x3(boc[-1], 2 * cfg.latent_channels, dtype=dt,
                                     out_dtype=torch.float32, device=device)
        self.dtype = dt

    def forward(self, x):
        x = self.conv_in(x.to(self.dtype))
        for blk in self.down_blocks:
            for res in blk.resnets:
                x = res(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
        x = _run_mid(self.mid_block, x)
        return self.conv_out(self.conv_norm_out(x))  # moments: [mean | logvar]


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        dt = cfg.dtype
        boc = cfg.block_out_channels
        n = len(boc)
        mid = boc[-1]
        self.conv_in = SmallConv3x3(cfg.latent_channels, mid, dtype=dt, device=device)
        self.mid_block = _mid_block(mid, dt, device)
        x_ch = mid
        blocks = []
        for bi in reversed(range(n)):
            ch = boc[bi]
            resnets = []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock2D(x_ch, ch, dtype=dt, device=device))
                x_ch = ch
            samplers = [Upsample2D(ch, dtype=dt, device=device)] if bi > 0 else None
            blocks.append(Block(resnets, (), samplers, "upsamplers"))
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = GroupNorm(boc[0], act="silu", device=device)
        self.conv_out = SmallConv3x3(boc[0], cfg.out_channels, dtype=dt,
                                     out_dtype=torch.float32, device=device)
        self.dtype = dt

    def forward(self, z):
        x = self.conv_in(z.to(self.dtype))
        x = _run_mid(self.mid_block, x)
        for blk in self.up_blocks:
            for res in blk.resnets:
                x = res(x)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)
        return self.conv_out(self.conv_norm_out(x))


class AutoencoderKL(nn.Module):
    """encode -> (mean, logvar) moments; decode -> image in [-1, 1] (fp32).
    All public tensors are NHWC."""

    def __init__(self, config: VAEConfig, device: Union[str, torch.device] = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        lc = config.latent_channels
        self.encoder = Encoder(config, device=device)
        self.decoder = Decoder(config, device=device)
        self.quant_conv = Conv2d(2 * lc, 2 * lc, 1, device=device)
        self.post_quant_conv = Conv2d(lc, lc, 1, device=device)

    def encode_moments(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        moments = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2)))
        mean, logvar = moments.permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, x: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Sample (or, without a generator, take the mode of) the latent
        posterior, unscaled."""
        mean, logvar = self.encode_moments(x)
        if generator is None:
            return mean
        noise = torch.randn(mean.shape, generator=generator, device=mean.device)
        return mean + torch.exp(0.5 * logvar) * noise

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        img = self.decoder(self.post_quant_conv(z.float().permute(0, 3, 1, 2)))
        return img.permute(0, 2, 3, 1)

"""UNet2DCondition (port of ``distdiff_tpu/models/unet.py``), SD-1.x and
tiny geometries, with diffusers' state-dict names.

The public call takes NHWC latents ``[B, h, w, C_in]`` and returns the fp32
prediction in NHWC; inside, the network runs NCHW. The reference's
``deep_cache``/``segment`` variants and SDXL's additive conditioning are not
ported; its ``nn.remat`` does not change values and has no counterpart.
"""

from __future__ import annotations

from typing import Union

import torch
import torch.nn as nn

from distdiff_tpu_torch.config import UNetConfig
from distdiff_tpu_torch.device import resolve_device
from distdiff_tpu_torch.models.layers import (
    Block,
    Downsample2D,
    GroupNorm,
    ResnetBlock2D,
    SmallConv3x3,
    TimestepEmbedding,
    Transformer2DModel,
    Upsample2D,
    timestep_embedding,
)


class UNet2DConditionModel(nn.Module):
    def __init__(self, config: UNetConfig, device: Union[str, torch.device] = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        cfg = config
        dt = cfg.dtype
        kw = dict(dtype=dt, device=device)
        boc = cfg.block_out_channels
        n = len(boc)
        temb = cfg.time_embed_dim
        ctx_dim = cfg.cross_attention_dim

        def transformer(ch, bi):
            heads = cfg.heads_at(bi)
            return Transformer2DModel(ch, heads, ch // heads, ctx_dim,
                                      depth=cfg.depth_at(bi), **kw)

        self.conv_in = SmallConv3x3(cfg.in_channels, boc[0], **kw)
        self.time_embedding = TimestepEmbedding(boc[0], temb, dtype=dt, device=device)

        skips = [boc[0]]
        x_ch = boc[0]
        down = []
        for bi, ch in enumerate(boc):
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(x_ch, ch, temb, **kw))
                x_ch = ch
                if cfg.cross_attention[bi] and cfg.depth_at(bi) > 0:
                    attns.append(transformer(ch, bi))
                skips.append(ch)
            samplers = None
            if bi < n - 1:
                samplers = [Downsample2D(ch, **kw)]
                skips.append(ch)
            down.append(Block(resnets, attns, samplers, "downsamplers"))
        self.down_blocks = nn.ModuleList(down)

        mid = boc[-1]
        self.mid_block = Block(
            [ResnetBlock2D(mid, mid, temb, **kw), ResnetBlock2D(mid, mid, temb, **kw)],
            [transformer(mid, n - 1)])

        up = []
        for ui in range(n):
            bi = n - 1 - ui
            ch = boc[bi]
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock2D(x_ch + skips.pop(), ch, temb, **kw))
                x_ch = ch
                if cfg.cross_attention[bi] and cfg.depth_at(bi) > 0:
                    attns.append(transformer(ch, bi))
            samplers = [Upsample2D(ch, **kw)] if bi > 0 else None
            up.append(Block(resnets, attns, samplers, "upsamplers"))
        self.up_blocks = nn.ModuleList(up)
        assert not skips

        self.conv_norm_out = GroupNorm(boc[0], act="silu", device=device)
        self.conv_out = SmallConv3x3(boc[0], cfg.out_channels, dtype=dt,
                                     out_dtype=torch.float32, device=device)

    def forward(self, sample: torch.Tensor, timestep, encoder_hidden_states: torch.Tensor
                ) -> torch.Tensor:
        """``sample [B, h, w, C_in]`` (NHWC), ``timestep`` int or ``[B]``,
        ``encoder_hidden_states [B, T, D_ctx]`` -> fp32 ``[B, h, w, C_out]``."""
        cfg = self.config
        dt = cfg.dtype
        b = sample.shape[0]
        t = torch.as_tensor(timestep, device=sample.device).reshape(-1)
        if t.shape[0] == 1 and b > 1:
            t = t.expand(b)
        temb = self.time_embedding(timestep_embedding(t, cfg.block_out_channels[0]))
        context = encoder_hidden_states.to(dt)
        x = self.conv_in(sample.permute(0, 3, 1, 2).to(dt))

        skips = [x]
        for blk in self.down_blocks:
            for li, res in enumerate(blk.resnets):
                x = res(x, temb)
                if len(blk.attentions):
                    x = blk.attentions[li](x, context)
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
                skips.append(x)

        x = self.mid_block.resnets[0](x, temb)
        x = self.mid_block.attentions[0](x, context)
        x = self.mid_block.resnets[1](x, temb)

        for blk in self.up_blocks:
            for li, res in enumerate(blk.resnets):
                x = res(torch.cat([x, skips.pop()], dim=1), temb)
                if len(blk.attentions):
                    x = blk.attentions[li](x, context)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)

        x = self.conv_out(self.conv_norm_out(x))
        return x.float().permute(0, 2, 3, 1)

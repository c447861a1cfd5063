"""UNet2DCondition (port of ``distdiff_tpu/models/unet.py``), SD-1.x,
SD-2.1 and tiny geometries, with diffusers' state-dict names.

The public call takes NHWC latents ``[B, h, w, C_in]`` and returns the fp32
prediction in NHWC; inside, the network runs NCHW. It takes the JAX
package's DeepCache arguments (``return_cache``, ``deep_cache``,
``cache_branch``); its pipeline-parallel ``segment``/``skips`` and SDXL's
additive conditioning are not ported. With ``config.remat``, and only while
autograd records, each ``ResnetBlock2D`` and ``Transformer2DModel`` runs
under a non-reentrant ``torch.utils.checkpoint``, where the JAX package
puts its ``nn.remat``; the values are the same either way.
"""

from __future__ import annotations

from typing import Optional, Union

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
    remat_call,
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
                                      depth=cfg.depth_at(bi),
                                      linear=cfg.linear_projection, **kw)

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

    def _block(self, module, *args):
        return remat_call(self.config.remat, module, *args)

    def forward(self, sample: torch.Tensor, timestep, encoder_hidden_states: torch.Tensor,
                deep_cache: Optional[torch.Tensor] = None, return_cache: bool = False,
                cache_branch: int = 0):
        """``sample [B, h, w, C_in]`` (NHWC), ``timestep`` int or ``[B]``,
        ``encoder_hidden_states [B, T, D_ctx]`` -> fp32 ``[B, h, w, C_out]``.

        DeepCache (Ma et al. 2023): ``return_cache=True`` runs the whole
        network and also returns the feature entering up group
        ``n_blocks - 1 - cache_branch`` (the output of everything below
        down level ``cache_branch``); ``deep_cache=<that feature>`` runs
        only down levels ``<= cache_branch``, stopping before that level's
        downsample, takes the cached feature in place of the deep
        subnetwork and runs the remaining up groups. The feature is NCHW,
        as the network holds it."""
        cfg = self.config
        dt = cfg.dtype
        b = sample.shape[0]
        n_blocks = len(cfg.block_out_channels)
        shallow = deep_cache is not None
        if shallow or return_cache:
            if not 0 <= cache_branch < n_blocks - 1:
                raise ValueError(f"cache_branch {cache_branch} outside [0, {n_blocks - 1})")
        cache_ui = n_blocks - 1 - cache_branch  # the up group the cache enters
        t = torch.as_tensor(timestep, device=sample.device).reshape(-1)
        if t.shape[0] == 1 and b > 1:
            t = t.expand(b)
        temb = self.time_embedding(timestep_embedding(t, cfg.block_out_channels[0]))
        context = encoder_hidden_states.to(dt)
        x = self.conv_in(sample.permute(0, 3, 1, 2).to(dt))

        skips = [x]
        down = self.down_blocks[:cache_branch + 1] if shallow else self.down_blocks
        for bi, blk in enumerate(down):
            for li, res in enumerate(blk.resnets):
                x = self._block(res, x, temb)
                if len(blk.attentions):
                    x = self._block(blk.attentions[li], x, context)
                skips.append(x)
            # the shallow path stops before cache_branch's downsample: its
            # skip belongs to the cached deep subnetwork
            if hasattr(blk, "downsamplers") and not (shallow and bi == cache_branch):
                x = blk.downsamplers[0](x)
                skips.append(x)

        if shallow:
            x = deep_cache.to(dt)
            up_groups = range(cache_ui, n_blocks)
        else:
            x = self._block(self.mid_block.resnets[0], x, temb)
            x = self._block(self.mid_block.attentions[0], x, context)
            x = self._block(self.mid_block.resnets[1], x, temb)
            up_groups = range(n_blocks)

        cache_out = None
        for ui in up_groups:
            blk = self.up_blocks[ui]
            if return_cache and ui == cache_ui:
                cache_out = x
            for li, res in enumerate(blk.resnets):
                x = self._block(res, torch.cat([x, skips.pop()], dim=1), temb)
                if len(blk.attentions):
                    x = self._block(blk.attentions[li], x, context)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)
        assert not skips, f"unconsumed skip states: {len(skips)}"

        x = self.conv_out(self.conv_norm_out(x))
        out = x.float().permute(0, 2, 3, 1)
        return (out, cache_out) if return_cache else out

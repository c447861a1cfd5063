"""Plain fp32 UNet2DConditionModel, built from a diffusers ``unet/config.json``
(the keys of ``portbench/configs/<config>.json`` under ``"unet"``), with
diffusers' state-dict names. NHWC latents in and out, NCHW inside.

Read from the config: ``block_out_channels``, ``layers_per_block``,
``down_block_types`` (a ``CrossAttn`` block carries transformers),
``attention_head_dim`` (diffusers' name for the number of heads of a
level), ``transformer_layers_per_block``, ``cross_attention_dim``,
``use_linear_projection`` and, for SDXL's ``addition_embed_type``
``"text_time"``, ``projection_class_embeddings_input_dim``. The additive
input is the ``[pooled text | time-id embedding]`` vector itself: the
benchmark makes it, so ``add_time_proj``'s sinusoid is outside the UNet.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from portbench.reference.layers import (
    Block,
    Downsample2D,
    GroupNorm,
    ResnetBlock2D,
    TimestepEmbedding,
    Transformer2DModel,
    Upsample2D,
    blockwise,
    timestep_embedding,
)


def _per_level(value, n: int) -> list:
    return list(value) if isinstance(value, (list, tuple)) else [value] * n


class UNet(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        boc = list(cfg["block_out_channels"])
        n = len(boc)
        lpb = cfg["layers_per_block"]
        cross = [t.startswith("CrossAttn") for t in cfg["down_block_types"]]
        heads = _per_level(cfg["attention_head_dim"], n)
        depth = _per_level(cfg.get("transformer_layers_per_block", 1), n)
        ctx = cfg["cross_attention_dim"]
        linear = bool(cfg.get("use_linear_projection", False))
        temb = 4 * boc[0]
        self.boc = boc
        self.remat = False

        def transformer(level):
            return Transformer2DModel(boc[level], heads[level], ctx, depth[level], linear)

        self.conv_in = nn.Conv2d(cfg["in_channels"], boc[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(boc[0], temb)
        self.add_embedding = None
        if cfg.get("addition_embed_type") == "text_time":
            self.add_embedding = TimestepEmbedding(
                cfg["projection_class_embeddings_input_dim"], temb)
        skips, x_ch, down = [boc[0]], boc[0], []
        for bi, ch in enumerate(boc):
            res, att = [], []
            for _ in range(lpb):
                res.append(ResnetBlock2D(x_ch, ch, temb))
                x_ch = ch
                if cross[bi]:
                    att.append(transformer(bi))
                skips.append(ch)
            samplers = None
            if bi < n - 1:
                samplers = [Downsample2D(ch)]
                skips.append(ch)
            down.append(Block(res, att, samplers, "downsamplers"))
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = Block([ResnetBlock2D(boc[-1], boc[-1], temb),
                                ResnetBlock2D(boc[-1], boc[-1], temb)],
                               [transformer(n - 1)])
        up = []
        for ui in range(n):
            bi = n - 1 - ui
            res, att = [], []
            for _ in range(lpb + 1):
                res.append(ResnetBlock2D(x_ch + skips.pop(), boc[bi], temb))
                x_ch = boc[bi]
                if cross[bi]:
                    att.append(transformer(bi))
            samplers = [Upsample2D(boc[bi])] if bi > 0 else None
            up.append(Block(res, att, samplers, "upsamplers"))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = GroupNorm(boc[0], silu=True)
        self.conv_out = nn.Conv2d(boc[0], cfg["out_channels"], 3, padding=1)

    def forward(self, sample, t: int, context, add=None):
        """``sample [B, h, w, C]`` NHWC, an integer timestep, ``context [B, T,
        D]`` (and SDXL's ``add [B, A]``) -> the prediction, NHWC."""
        def run(m, *args):
            return blockwise(self.remat, m, *args)

        b = sample.shape[0]
        tt = torch.full((b,), float(t), device=sample.device)
        temb = self.time_embedding(timestep_embedding(tt, self.boc[0]))
        if self.add_embedding is not None:
            temb = temb + self.add_embedding(add)
        x = self.conv_in(sample.permute(0, 3, 1, 2))
        skips = [x]
        for blk in self.down_blocks:
            for li, res in enumerate(blk.resnets):
                x = run(res, x, temb)
                if len(blk.attentions):
                    x = run(blk.attentions[li], x, context)
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
                skips.append(x)
        x = run(self.mid_block.resnets[0], x, temb)
        x = run(self.mid_block.attentions[0], x, context)
        x = run(self.mid_block.resnets[1], x, temb)
        for blk in self.up_blocks:
            for li, res in enumerate(blk.resnets):
                x = run(res, torch.cat([x, skips.pop()], dim=1), temb)
                if len(blk.attentions):
                    x = run(blk.attentions[li], x, context)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)
        return self.conv_out(self.conv_norm_out(x)).permute(0, 2, 3, 1)

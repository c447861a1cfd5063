"""Plain fp32 AutoencoderKL, built from a diffusers ``vae/config.json`` (the
keys under ``"vae"``), with diffusers' state-dict names. Only ``decode`` runs;
the encoder is built so that the whole state dict loads strictly (the
benchmark draws the source latents, as the CLI caches them at set-up).
"""

from __future__ import annotations

import torch.nn as nn

from portbench.reference.layers import (
    Block,
    Downsample2D,
    GroupNorm,
    ResnetBlock2D,
    Upsample2D,
    attend,
    blockwise,
)


class VAEAttention(nn.Module):
    """One head of width C over the spatial positions."""

    def __init__(self, c: int):
        super().__init__()
        self.group_norm = GroupNorm(c)
        self.to_q = nn.Linear(c, c)
        self.to_k = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).flatten(2).transpose(1, 2)
        q, k, v = (f(y)[:, None] for f in (self.to_q, self.to_k, self.to_v))
        out = self.to_out[0](attend(q, k, v)[:, 0])
        return x + out.transpose(1, 2).reshape(b, c, h, w)


def _mid(c: int) -> Block:
    return Block([ResnetBlock2D(c, c), ResnetBlock2D(c, c)], [VAEAttention(c)])


def _run_mid(mid: Block, x, remat: bool = False):
    for m in (mid.resnets[0], mid.attentions[0], mid.resnets[1]):
        x = blockwise(remat, m, x)
    return x


class Encoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        boc = list(cfg["block_out_channels"])
        self.conv_in = nn.Conv2d(cfg["in_channels"], boc[0], 3, padding=1)
        x_ch, blocks = boc[0], []
        for bi, ch in enumerate(boc):
            res = []
            for _ in range(cfg["layers_per_block"]):
                res.append(ResnetBlock2D(x_ch, ch))
                x_ch = ch
            samplers = [Downsample2D(ch)] if bi < len(boc) - 1 else None
            blocks.append(Block(res, (), samplers, "downsamplers"))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _mid(boc[-1])
        self.conv_norm_out = GroupNorm(boc[-1], silu=True)
        self.conv_out = nn.Conv2d(boc[-1], 2 * cfg["latent_channels"], 3, padding=1)


class Decoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        boc = list(cfg["block_out_channels"])
        self.conv_in = nn.Conv2d(cfg["latent_channels"], boc[-1], 3, padding=1)
        self.mid_block = _mid(boc[-1])
        x_ch, blocks = boc[-1], []
        for bi in reversed(range(len(boc))):
            res = []
            for _ in range(cfg["layers_per_block"] + 1):
                res.append(ResnetBlock2D(x_ch, boc[bi]))
                x_ch = boc[bi]
            samplers = [Upsample2D(boc[bi])] if bi > 0 else None
            blocks.append(Block(res, (), samplers, "upsamplers"))
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = GroupNorm(boc[0], silu=True)
        self.conv_out = nn.Conv2d(boc[0], cfg["out_channels"], 3, padding=1)
        self.remat = False

    def forward(self, z):
        x = _run_mid(self.mid_block, self.conv_in(z), self.remat)
        for blk in self.up_blocks:
            for res in blk.resnets:
                x = blockwise(self.remat, res, x)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)
        return self.conv_out(self.conv_norm_out(x))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        lc = cfg["latent_channels"]
        self.scaling_factor = cfg["scaling_factor"]
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * lc, 2 * lc, 1)
        self.post_quant_conv = nn.Conv2d(lc, lc, 1)

    def decode(self, latents):
        """Scaled NHWC latents -> NHWC images in [-1, 1] (unclamped)."""
        z = (latents / self.scaling_factor).permute(0, 3, 1, 2)
        return self.decoder(self.post_quant_conv(z)).permute(0, 2, 3, 1)

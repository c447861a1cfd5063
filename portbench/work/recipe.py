"""The recipe's steps and shapes per batch, from a configuration file and a
traffic mix alone (diffusers' config keys; no call into the program).

A guided batch of B images (transform guidance, the whole batch at once, as
``SplitExpand`` runs it without a ``guide_chunk``) runs the UNet on the CFG
pair (2B rows) at every plain step and at each of the ``period`` rollout
steps, the VAE decoder on B rows at each rollout step and once at the end,
and the backward of the rollout once. Where the program recomputes a part in
the backward (its ``rollout_remat`` mode), that is extra work; ``launches``
counts it, ``needed`` does not.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple


def down(side: int) -> int:
    return (side + 1) // 2  # 3x3, stride 2, padding 1


def latent_side(cfg: dict) -> int:
    return cfg["sample_size"] // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)


def per_level(value, n: int) -> list:
    return list(value) if isinstance(value, (list, tuple)) else [value] * n


def unet_levels(u: dict):
    """(channels, heads, depth, cross) per down level."""
    boc = u["block_out_channels"]
    n = len(boc)
    cross = [t.startswith("CrossAttn") for t in u["down_block_types"]]
    return list(zip(boc, per_level(u["attention_head_dim"], n),
                    per_level(u.get("transformer_layers_per_block", 1), n), cross))


@dataclasses.dataclass(frozen=True)
class Steps:
    plain: int      # UNet calls on the CFG pair outside the rollout
    period: int     # rollout steps (0: unguided)
    batch: int


def steps(traffic: dict) -> Steps:
    n = traffic["steps"]
    start = min(max(int((1.0 - traffic["strength"]) * n), 0), n - 1)
    g = traffic["guidance"]
    if g["type"] == "none":
        return Steps(n - start, 0, traffic["batch"])
    if g["type"] != "transform_guidance":
        raise ValueError(f"the work of {g['type']!r} is not counted")
    g0 = n - g["step"]
    if g0 < start:
        return Steps(n - start, 0, traffic["batch"])
    return Steps(n - start, g["period"], traffic["batch"])


def unet_self_attentions(u: dict, side: int) -> List[Tuple[int, int, int, int]]:
    """(heads, tokens, head width, count) of one UNet call's self-attentions."""
    levels = unet_levels(u)
    lpb = u["layers_per_block"]
    out, s = [], side
    for bi, (ch, heads, depth, cross) in enumerate(levels):
        if cross:
            out.append((heads, s * s, ch // heads, depth * (2 * lpb + 1)))
        if bi < len(levels) - 1:
            s = down(s)
    ch, heads, depth, _ = levels[-1]
    out.append((heads, s * s, ch // heads, depth))  # the mid block
    return out


def unet_norms(u: dict, side: int) -> List[Tuple[int, int]]:
    """(channels, side) of every GroupNorm of one UNet call, in order."""
    levels = unet_levels(u)
    lpb = u["layers_per_block"]
    boc = [lv[0] for lv in levels]
    out, skips, x_ch, s = [], [boc[0]], boc[0], side
    for bi, (ch, _, depth, cross) in enumerate(levels):
        for _ in range(lpb):
            out += [(x_ch, s), (ch, s)]
            x_ch = ch
            if cross:
                out.append((ch, s))
            skips.append(ch)
        if bi < len(levels) - 1:
            skips.append(ch)
            s = down(s)
    out += [(boc[-1], s)] * 5  # mid: two resnets around the transformer
    for ui in range(len(levels)):
        bi = len(levels) - 1 - ui
        ch, _, _, cross = levels[bi]
        for _ in range(lpb + 1):
            out += [(x_ch + skips.pop(), s), (ch, s)]
            x_ch = ch
            if cross:
                out.append((ch, s))
        if bi > 0:
            s *= 2
    return out + [(boc[0], s)]


def decoder_norms(v: dict, side: int) -> List[Tuple[int, int]]:
    """The same for one VAE decode of a side^2 latent."""
    boc = v["block_out_channels"]
    out, x_ch, s = [(boc[-1], side)] * 5, boc[-1], side
    for bi in reversed(range(len(boc))):
        for _ in range(v["layers_per_block"] + 1):
            out += [(x_ch, s), (boc[bi], s)]
            x_ch = boc[bi]
        if bi > 0:
            s *= 2
    return out + [(boc[0], s)]


def vae_attention(v: dict, side: int) -> Tuple[int, int, int]:
    """(heads, tokens, width) of the decoder's mid-block attention."""
    return 1, side * side, v["block_out_channels"][-1]

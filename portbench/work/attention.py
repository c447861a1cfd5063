"""Attention work per batch and its roofline bound.

``bound_s`` is the least time the H100 can take for one kernel's job: the
larger of the bytes it must move (each input read once, each output written
once) over the memory rate and its operations (products on the bf16 tensor
cores, exponentials on the special-function units) over their peaks.

Only attention over more than 256 kv tokens is counted: shorter attention
(the 77-token cross-attention, the deepest levels) is plain matmuls and a
softmax in the program, with no kernel of its own to hold against a bound.
``needed`` counts the forward of every attention the recipe runs and the
backward of each rollout attention once (the fused backward's work: five
products); ``launches`` adds the program's recomputation under its
``rollout_remat`` mode and its route (the fused backward up to head width
128, the dq and dk/dv pair above), to be held against the program's own
launch counters.
"""

from __future__ import annotations

import collections

from portbench.work.peaks import PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_EXP, PEAK_TF32_FLOPS
from portbench.work.recipe import (
    latent_side,
    steps,
    unet_self_attentions,
    vae_attention,
)

SMALL_KV = 256
# products (each 2 * BH * Tq * Tk * D flops) of each kernel
PRODUCTS = {"flash_fwd": 2, "flash_bwd_fused": 5, "flash_bwd_dq": 3, "flash_bwd_dkv": 4}
FUSED_BWD_MAX_D = 128
# UNet calls and VAE attention forwards of a rollout step, first steps and
# last, forward and backward, by rollout_remat mode: the outer checkpoint
# re-runs a step, the UNet's inner checkpoints its blocks
ROLLOUT_CALLS = {
    "step_nr": ((2, 2), (2, 2)), "step": ((3, 2), (3, 2)), "step_nru": ((2, 2), (2, 2)),
    "decode_nr": ((3, 2), (3, 2)), "block": ((2, 1), (2, 1)), "decode": ((2, 2), (2, 2)),
    "tail": ((3, 2), (2, 1)), "tail_decode_nr": ((3, 2), (2, 1)),
}
DEFAULT_REMAT = "step_nr"


def bound_s(name: str, bh: int, tq: int, tk: int, d: int, itemsize: int = 2) -> float:
    q, kv, row = bh * tq * d * itemsize, bh * tk * d * itemsize, bh * tq * 4
    nbytes = {
        "flash_fwd": q + 2 * kv + q + row,                            # q,k,v -> o, lse
        "flash_bwd_fused": 2 * q + 2 * kv + 2 * row + q + 2 * kv,     # +do,lse,delta -> dq,dk,dv
        "flash_bwd_dq": 2 * q + 2 * kv + 2 * row + q,
        "flash_bwd_dkv": 2 * q + 2 * kv + 2 * row + 2 * kv,
    }[name]
    flops = PRODUCTS[name] * 2.0 * bh * tq * tk * d
    t_products = flops / PEAK_BF16_FLOPS if itemsize == 2 else 3 * flops / PEAK_TF32_FLOPS
    return max(nbytes / PEAK_BYTES, t_products, bh * tq * tk / PEAK_EXP)


def _shapes(cfg: dict, traffic: dict):
    """[(rows, heads, tokens, width, forwards, backwards)] of one batch's
    attentions, needed work only."""
    st = steps(traffic)
    side = latent_side(cfg)
    b = st.batch
    out = [(2 * b, h, t, d, k * (st.plain + st.period), k * st.period)
           for h, t, d, k in unet_self_attentions(cfg["unet"], side)]
    h, t, d = vae_attention(cfg["vae"], side)
    out.append((b, h, t, d, st.period + 1, st.period))
    return [s for s in out if s[2] > SMALL_KV]


def needed(cfg: dict, traffic: dict) -> collections.Counter:
    """{(("fwd" | "bwd"), (BH, T, T, D)): count} of one batch."""
    work = collections.Counter()
    for rows, h, t, d, fwd, bwd in _shapes(cfg, traffic):
        work[("fwd", (rows * h, t, t, d))] += fwd
        if bwd:
            work[("bwd", (rows * h, t, t, d))] += bwd
    return work


def needed_bound_s(cfg: dict, traffic: dict) -> float:
    """The roofline time of one batch's attention work."""
    kernel = {"fwd": "flash_fwd", "bwd": "flash_bwd_fused"}
    return sum(n * bound_s(kernel[kind], *shape)
               for (kind, shape), n in needed(cfg, traffic).items())


def launches(cfg: dict, traffic: dict, mode: str = DEFAULT_REMAT) -> collections.Counter:
    """{(kernel, (BH, T, T, D)): launches} of one batch on the program's
    route, recomputation included."""
    st = steps(traffic)
    side = latent_side(cfg)
    b, p = st.batch, st.period
    first, last = ROLLOUT_CALLS[mode]
    unet_fwd = (p - 1) * first[0] + last[0] if p else 0
    vae_fwd = (p - 1) * first[1] + last[1] if p else 0
    plan = collections.Counter()

    def attend(rows, heads, tokens, d, fwd, bwd):
        if tokens <= SMALL_KV:
            return
        shape = (rows * heads, tokens, tokens, d)
        plan[("flash_fwd", shape)] += fwd
        for name in (("flash_bwd_fused",) if d <= FUSED_BWD_MAX_D
                     else ("flash_bwd_dq", "flash_bwd_dkv")):
            if bwd:
                plan[(name, shape)] += bwd

    for h, t, d, k in unet_self_attentions(cfg["unet"], side):
        attend(2 * b, h, t, d, k * (st.plain + unet_fwd), k * p)
    h, t, d = vae_attention(cfg["vae"], side)
    attend(b, h, t, d, vae_fwd + 1, p)
    return plan


def launch_totals(cfg: dict, traffic: dict, mode: str = DEFAULT_REMAT) -> dict:
    totals = dict.fromkeys(PRODUCTS, 0)
    for (name, _), n in launches(cfg, traffic, mode).items():
        totals[name] += n
    return totals

"""GroupNorm work per batch and its roofline bound.

A GroupNorm (with or without its SiLU) must read its slab once and write it
once: ``bound_s`` is those bytes over the memory rate. ``needed`` counts the
forward of every norm the recipe runs, ``launches`` the program's kernels
as it routes them (``gn_fused`` where a (row, group) span and the kernel's
header fit a block's shared memory, else the ``gn_stats`` + ``gn_apply``
pair), recomputation under the default ``rollout_remat`` mode included: the
rollout's UNet calls and decodes run twice, their backward through plain
operations.
"""

from __future__ import annotations

import collections

from portbench.work.peaks import PEAK_BYTES
from portbench.work.recipe import decoder_norms, latent_side, steps, unet_norms

H100_SMEM_OPTIN = 232448  # bytes of shared memory a block may opt into
_RED_FLOATS = 68


def groups_of(c: int, num_groups: int = 32) -> int:
    g = min(num_groups, c)
    while c % g:
        g -= 1
    return g


def fused_fits(c: int, spatial: int, itemsize: int = 2, smem: int = H100_SMEM_OPTIN) -> bool:
    cpg = c // groups_of(c)
    header = (4 * (_RED_FLOATS + 2 * cpg) + 15) // 16 * 16
    return header + cpg * spatial * itemsize <= smem


def bound_s(shape, itemsize: int = 2) -> float:
    b, c, h, w = shape
    return 2 * b * c * h * w * itemsize / PEAK_BYTES


def _calls(cfg: dict, traffic: dict, recompute: int):
    st = steps(traffic)
    side = latent_side(cfg)
    b, p = st.batch, st.period
    unet = unet_norms(cfg["unet"], side)
    dec = decoder_norms(cfg["vae"], side)
    return [(st.plain + recompute * p, 2 * b, unet), (recompute * p, b, dec), (1, b, dec)]


def needed(cfg: dict, traffic: dict) -> collections.Counter:
    """{(B, C, H, W): count} of one batch's norms."""
    work = collections.Counter()
    for times, b, norms in _calls(cfg, traffic, 1):
        for c, s in norms:
            if times:
                work[(b, c, s, s)] += times
    return work


def needed_bound_s(cfg: dict, traffic: dict) -> float:
    return sum(n * bound_s(shape) for shape, n in needed(cfg, traffic).items())


def launches(cfg: dict, traffic: dict) -> collections.Counter:
    """{(kernel, (B, C, H, W)): launches} of one batch."""
    plan = collections.Counter()
    for times, b, norms in _calls(cfg, traffic, 2):
        for c, s in norms:
            if not times:
                continue
            if fused_fits(c, s * s):
                plan[("gn_fused", (b, c, s, s))] += times
            else:
                plan[("gn_stats", (b, c, s, s))] += times
                plan[("gn_apply", (b, c, s, s))] += times
    return plan


def launch_totals(cfg: dict, traffic: dict) -> dict:
    totals = {"gn_fused": 0, "gn_stats": 0, "gn_apply": 0}
    for (name, _), n in launches(cfg, traffic).items():
        totals[name] += n
    return totals

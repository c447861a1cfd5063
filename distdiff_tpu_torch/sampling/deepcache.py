"""DeepCache-style denoising (port of ``distdiff_tpu/sampling/deepcache.py``),
an opt-in approximation: adjacent steps' deep UNet features barely move,
so a full UNet step every ``interval`` steps refreshes a cached deep
feature, and the steps between run only the shallow levels on it (Ma et
al. 2023).

Never the default. Guidance steps run the full UNet (its gradient flows
through the denoiser), and the cache starts cold on every span, so the
guidance splices stay exact. DDIM only.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from distdiff_tpu_torch.sampling.conditioning import cond_concat
from distdiff_tpu_torch.sampling.sampler import SamplerConfig
from distdiff_tpu_torch.schedulers import DDIMSchedule, ddim_step


def make_cached_eps_fns(unet_full: Callable, unet_shallow: Callable,
                        cfg: SamplerConfig) -> Tuple[Callable, Callable]:
    """The CFG-merged pair of ``sampler.make_eps_fn``:

      eps_full(x, t, cond, uncond)           -> (eps, cache)
      eps_shallow(x, t, cond, uncond, cache) -> eps

    from ``unet_full(x, t, ctx) -> (out, cache)`` and ``unet_shallow(x, t,
    ctx, cache) -> out``. The cache is the CFG-doubled batch's, so both the
    conditional and the unconditional deep features are kept."""

    def cfg_mix(out):
        eps_u, eps_t = out.chunk(2, dim=0)
        return eps_u + cfg.guidance_scale * (eps_t - eps_u)

    def eps_full(x, t, cond, uncond):
        if cfg.do_classifier_free_guidance:
            out, cache = unet_full(torch.cat([x, x], dim=0), t, cond_concat(uncond, cond))
            return cfg_mix(out), cache
        return unet_full(x, t, cond)

    def eps_shallow(x, t, cond, uncond, cache):
        if cfg.do_classifier_free_guidance:
            return cfg_mix(unet_shallow(torch.cat([x, x], dim=0), t,
                                        cond_concat(uncond, cond), cache))
        return unet_shallow(x, t, cond, cache)

    return eps_full, eps_shallow


def denoise_range_cached(sched: DDIMSchedule, eps_full: Callable, eps_shallow: Callable,
                         latents, cond, uncond, start: int, stop: int,
                         interval: int) -> torch.Tensor:
    """DDIM over plan steps [start, stop): a full step at ``start`` and
    every ``interval`` steps after it, shallow steps on the cache between
    (``interval`` <= 1: every step full). The cache is cold at ``start``."""
    interval = max(interval, 1)
    x, cache = latents, None
    for i in range(start, stop):
        t = int(sched.timesteps[i])
        if cache is None or (i - start) % interval == 0:
            e, cache = eps_full(x, t, cond, uncond)
        else:
            e = eps_shallow(x, t, cond, uncond, cache)
        x, _ = ddim_step(sched, e, i, x)
    return x

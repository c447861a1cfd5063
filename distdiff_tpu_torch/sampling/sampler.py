"""Sampling with classifier-free guidance (port of
``distdiff_tpu/sampling/sampler.py``). The denoise loop is a Python loop
over plan indices, DDIM or DPM-Solver++(2M) by the schedule's type; latents
are NHWC ``[B, h, w, 4]``. The random draws are made by the caller and
handed in."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from distdiff_tpu_torch.sampling.conditioning import cond_concat
from distdiff_tpu_torch.schedulers import (
    DDIMSchedule,
    DPMSchedule,
    add_noise,
    ddim_step,
    denoise_range_dpm,
    img2img_start_index,
)


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    guidance_scale: float = 7.5
    do_classifier_free_guidance: bool = True


def unet_apply(unet: Callable, x, t, ctx, **kw):
    """The UNet on a conditioning value: a text context, or SDXL's
    ``{"ctx", "add"}`` dict (the context and the additive vector)."""
    if isinstance(ctx, dict):
        return unet(x, t, ctx["ctx"], ctx["add"], **kw)
    return unet(x, t, ctx, **kw)


def make_eps_fn(unet: Callable, cfg: SamplerConfig) -> Callable:
    """eps(x, t, cond, uncond): one CFG-merged UNet evaluation, with the
    uncond/cond pair batched through a single UNet call. ``unet(x, t,
    ctx)`` takes the conditioning as the caller holds it (``cond`` and
    ``uncond`` are opaque here: tensors, or SDXL's dicts)."""

    def eps_fn(x, t, cond, uncond):
        if cfg.do_classifier_free_guidance:
            out = unet(torch.cat([x, x], dim=0), t, cond_concat(uncond, cond))
            eps_u, eps_t = out.chunk(2, dim=0)
            return eps_u + cfg.guidance_scale * (eps_t - eps_u)
        return unet(x, t, cond)

    return eps_fn


def denoise_range(sched: DDIMSchedule, eps_fn: Callable, latents, cond, uncond,
                  start: int, stop: int) -> torch.Tensor:
    """Run plan steps [start, stop): the DPM-Solver++(2M) loop on a
    ``DPMSchedule`` (its x0 history empty at ``start``), else DDIM."""
    if isinstance(sched, DPMSchedule):
        return denoise_range_dpm(sched, eps_fn, latents, cond, uncond, start, stop)
    x = latents
    for i in range(start, stop):
        e = eps_fn(x, int(sched.timesteps[i]), cond, uncond)
        x, _ = ddim_step(sched, e, i, x)
    return x


def sample(sched: DDIMSchedule, eps_fn: Callable, init_latents, cond, uncond,
           start_index: int = 0,
           guided_segment: Optional[Tuple[int, int, Callable]] = None) -> torch.Tensor:
    """Denoise from plan index ``start_index`` to the end. With
    ``guided_segment = (g0, g1, guide_fn)``: plain steps [start, g0), then
    ``guide_fn(latents, cond, uncond)``, which advances the trajectory over
    [g0, g1), then plain steps [g1, end)."""
    n = sched.num_inference_steps
    if guided_segment is None:
        return denoise_range(sched, eps_fn, init_latents, cond, uncond, start_index, n)
    g0, g1, guide_fn = guided_segment
    g0 = max(g0, start_index)
    x = denoise_range(sched, eps_fn, init_latents, cond, uncond, start_index, g0)
    x = guide_fn(x, cond, uncond)
    return denoise_range(sched, eps_fn, x, cond, uncond, g1, n)


def img2img_init(sched: DDIMSchedule, image_latents: torch.Tensor,
                 noise: torch.Tensor, strength: float) -> Tuple[torch.Tensor, int]:
    """SDEdit entry: noise the cached latents to the strength-indexed
    timestep. ``noise`` (latents' shape) is drawn by the caller: standard
    normal, plus the offset under ``--offset_noise`` (``with_offset_noise``).
    Returns (latents, start_index)."""
    start = img2img_start_index(sched, strength)
    t_enc = int(sched.timesteps[start])
    noisy = add_noise(sched, image_latents.float(), noise, t_enc)
    return noisy.to(image_latents.dtype), start


def with_offset_noise(noise: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """``--offset_noise``: the img2img noise plus 0.1x one standard-normal
    draw per (sample, channel), ``offset`` ``[B, 1, 1, C]``, as the JAX
    ``img2img_init`` adds it."""
    return noise + 0.1 * offset


def text2img_init(noise: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Pure-noise entry (``--text_to_img``): the fp32 noise itself (DDIM's
    initial sigma is 1), from plan index 0."""
    return noise.float(), 0

"""DistDiff guidance optimizers (port of
``distdiff_tpu/guidance/optimize.py``), as autograd through the rollout.

  * transform: at the first window step, optimise a per-channel affine
    (gamma, beta) of the latents by one SGD step on the energy of a
    ``guidance_period``-step rollout, then clip to an l-inf ball around the
    original latents. The caller then denoises normally from that step.
  * direct: at every window step, advance the trajectory and descend the
    energy gradient on the latents themselves.

Where the transform mode's backward recomputes instead of storing is
``GuidanceConfig.rollout_remat``, as in the JAX package: an outer
non-reentrant ``torch.utils.checkpoint`` around each rollout step (UNet
step + VAE decode + resize + guide encode) in the "step*", "tail*" and
"decode_nr" modes ("tail*" leaves the last step without one), a checkpoint
around the decode + guide leg alone in "decode", and the models' inner
per-block checkpoints, which ``ExpansionPipeline.guidance_context`` turns
on or off in the eps and decode functions it hands over. Every mode gives
the same values.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from distdiff_tpu_torch.config import GuidanceConfig
from distdiff_tpu_torch.guidance.energy import hierarchical_energy_per_sample, normalize
from distdiff_tpu_torch.schedulers import DDIMSchedule, ddim_step


@dataclasses.dataclass(frozen=True)
class GuidanceContext:
    """What the guidance optimizers close over.

    eps_fn(x, t, cond, uncond) -> CFG-merged epsilon
    decode_fn(x0_latent)       -> guide-ready images [B, S, S, 3]
    encode_fn(images)          -> guide features [B, D] fp32
    """

    sched: DDIMSchedule
    eps_fn: Callable
    decode_fn: Callable
    encode_fn: Callable
    cfg: GuidanceConfig
    global_protos: Optional[torch.Tensor]
    local_protos: Optional[torch.Tensor]


def _step_energy(ctx: GuidanceContext, x, i: int, cond, uncond, targets,
                 do_normalize: bool, remat_decode: bool = False):
    """One DDIM step + decode + encode -> (x_next, per-sample energies [B]).
    ``remat_decode`` checkpoints the decode + encode leg alone (its input
    is the small pred-x0 latents; the decoder's activations are the
    rollout's largest)."""
    t = int(ctx.sched.timesteps[i])
    eps = ctx.eps_fn(x, t, cond, uncond)
    x_next, x0 = ddim_step(ctx.sched, eps, i, x)

    def feat_fn(z):
        return ctx.encode_fn(ctx.decode_fn(z))

    feats = checkpoint(feat_fn, x0, use_reentrant=False) if remat_decode else feat_fn(x0)
    if do_normalize:
        feats = normalize(feats)
    e = hierarchical_energy_per_sample(
        feats, targets,
        ctx.global_protos if ctx.cfg.wants_global() else None,
        ctx.local_protos if ctx.cfg.wants_local() else None,
        gs=ctx.cfg.gs, ls=ctx.cfg.ls,
    )
    return x_next, e


def transform_guidance(
    ctx: GuidanceContext,
    latents: torch.Tensor,          # [B, h, w, C] at the window start
    cond: torch.Tensor,
    uncond: torch.Tensor,
    targets: torch.Tensor,
    window_start: int,
    gamma0: torch.Tensor,           # [B, 1, 1, C] fp32, uniform [0, 1)
    beta0: torch.Tensor,            # [B, 1, 1, C] fp32, standard normal
) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Returns (updated latents at the same plan index, per-sample scores,
    (grad_gamma, grad_beta))."""
    cfg = ctx.cfg
    mode = cfg.rollout_remat
    outer = mode.startswith(("step", "tail")) or mode == "decode_nr"
    do_norm = cfg.normalize_features if cfg.normalize_features is not None else False
    lat32 = latents.float()
    gamma = gamma0.float().detach().requires_grad_(True)
    beta = beta0.float().detach().requires_grad_(True)
    with torch.enable_grad():
        x = (lat32 * (1.0 + gamma) + beta).to(latents.dtype)
        score = torch.zeros(latents.shape[0], dtype=torch.float32, device=latents.device)
        last = window_start + cfg.guidance_period - 1
        for i in range(window_start, last + 1):
            def step(xx, i=i):
                return _step_energy(ctx, xx, i, cond, uncond, targets, do_norm,
                                    remat_decode=mode == "decode")
            # "tail*": the last step's backward runs first, so without its
            # outer checkpoint only its own residuals are live at once
            if outer and not (mode.startswith("tail") and i == last):
                x, e = checkpoint(step, x, use_reentrant=False)
            else:
                x, e = step(x)
            score = score + e
        score = score / cfg.guidance_period
        # Sum over the batch: each sample's gamma/beta gradient equals its
        # batch-1 gradient (samples are independent).
        g_gamma, g_beta = torch.autograd.grad(score.sum(), (gamma, beta))
    new_gamma = gamma0.float() - cfg.rho * g_gamma
    new_beta = beta0.float() - cfg.rho * g_beta
    updated = lat32 * (1.0 + new_gamma) + new_beta
    # l-inf projection around the ORIGINAL latents
    updated = torch.clamp(updated, lat32 - cfg.constraint_value,
                          lat32 + cfg.constraint_value)
    return updated.detach().to(latents.dtype), score.detach(), (g_gamma, g_beta)


def direct_guidance_step(ctx: GuidanceContext, latents, cond, uncond, targets,
                         step_index: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advance one plan step and descend the energy gradient on the latents
    (features L2-normalised by default, unlike transform mode)."""
    cfg = ctx.cfg
    do_norm = cfg.normalize_features if cfg.normalize_features is not None else True
    x = latents.detach().requires_grad_(True)
    with torch.enable_grad():
        x_next, e = _step_energy(ctx, x, step_index, cond, uncond, targets, do_norm)
        (gx,) = torch.autograd.grad(e.sum(), (x,))
    return (x_next - cfg.rho * gx).detach(), e.detach()


def direct_guidance(ctx: GuidanceContext, latents, cond, uncond, targets,
                    window: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Direct guidance over every plan index in [window)."""
    scores = []
    x = latents
    for i in range(*window):
        x, s = direct_guidance_step(ctx, x, cond, uncond, targets, i)
        scores.append(s)
    return x, torch.stack(scores).mean()

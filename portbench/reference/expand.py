"""The plain fp32 DistDiff expansion of one source latent: img2img noising,
DDIM with classifier-free guidance, the transform-guidance update of the
DistDiff recipe, the final decode and the 8-bit rounding of the written PNG.

The schedule (diffusers' ``DDIMScheduler`` of SD's ``scheduler_config.json``:
scaled-linear betas, "leading" spacing, ``steps_offset`` 1,
``set_alpha_to_one`` false) is rebuilt here from the config's numbers.
Transform guidance (DistDiff, Zhu et al. 2024): at plan index g0 = steps -
guidance_step, one SGD step of rate rho on a per-channel affine (gamma, beta)
of the latents, on the mean over ``guidance_period`` rollout steps of the
prototype energy of the guide's features of each step's decoded pred-x0
(bicubic, antialiased, to the guide's input size), then an l-inf clip of
``constraint_value`` around the latents before the update.

``Expansion.images`` runs a batch (the CFG pair in one UNet call); with
``remat`` the rollout's backward recomputes each block of the UNet and the
decoder from its input instead of storing its insides, which changes no
value.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass
class Schedule:
    timesteps: np.ndarray       # int64, descending, the executed plan
    alphas: np.ndarray          # fp32 alpha-bar over the training steps
    step_alphas: np.ndarray     # fp32 alpha-bar at each plan step
    prev_alphas: np.ndarray     # fp32 alpha-bar at its target


def make_schedule(sched_cfg: dict, steps: int) -> Schedule:
    t_train = sched_cfg["num_train_timesteps"]
    if sched_cfg["beta_schedule"] != "scaled_linear":
        raise ValueError(f"beta_schedule {sched_cfg['beta_schedule']!r}")
    if sched_cfg.get("prediction_type", "epsilon") != "epsilon":
        raise ValueError(f"prediction_type {sched_cfg['prediction_type']!r}")
    betas = np.linspace(sched_cfg["beta_start"] ** 0.5, sched_cfg["beta_end"] ** 0.5,
                        t_train, dtype=np.float64) ** 2
    abar = np.cumprod(1.0 - betas)
    final = 1.0 if sched_cfg["set_alpha_to_one"] else abar[0]
    ratio = t_train // steps
    ts = (np.arange(steps) * ratio)[::-1].astype(np.int64) + sched_cfg["steps_offset"]
    prev = ts - ratio
    prev_a = np.where(prev >= 0, abar[np.clip(prev, 0, None)], final)
    return Schedule(ts, abar.astype(np.float32), abar[ts].astype(np.float32),
                    prev_a.astype(np.float32))


def ddim_step(s: Schedule, eps, i: int, x):
    a = torch.tensor(s.step_alphas[i], device=x.device)
    ap = torch.tensor(s.prev_alphas[i], device=x.device)
    x0 = (x - (1 - a).sqrt() * eps) / a.sqrt()
    return ap.sqrt() * x0 + (1 - ap).sqrt() * eps, x0


class Expansion:
    """The recipe of one cell over the reference modules ``unet``, ``vae``
    and ``guide`` (each fp32, or on the meta device to count work)."""

    def __init__(self, cfg: dict, traffic: dict, unet, vae, guide=None,
                 global_protos=None, local_protos=None, remat: bool = True):
        self.unet, self.vae, self.guide = unet, vae, guide
        self.gp, self.lp = global_protos, local_protos
        self.t = traffic
        self.guide_side = cfg["guide"]["input_size"]
        self.g = traffic["guidance"]
        self.steps = traffic["steps"]
        self.sched = make_schedule(cfg["scheduler"], self.steps)
        if traffic.get("scheduler", "ddim") != "ddim":
            raise ValueError(f"scheduler {traffic['scheduler']!r}")
        unet.remat = vae.decoder.remat = remat
        self.start = min(max(int((1.0 - traffic["strength"]) * self.steps), 0), self.steps - 1)
        kind = self.g["type"]
        g0 = self.steps - self.g.get("step", 0)
        g1 = g0 + self.g.get("period", 0)
        if kind == "transform_guidance":
            self.window = (g0, g1) if g0 >= self.start else None
        elif kind == "none":
            self.window = None
        else:
            raise ValueError(f"guidance type {kind!r}")

    # ---- the pieces ----
    def eps(self, x, i: int, cond, uncond):
        t = int(self.sched.timesteps[i])
        pair = torch.cat([x, x], dim=0)
        if isinstance(cond, dict):
            out = self.unet(pair, t, torch.cat([uncond["ctx"], cond["ctx"]]),
                            torch.cat([uncond["add"], cond["add"]]))
        else:
            out = self.unet(pair, t, torch.cat([uncond, cond]))
        e_u, e_c = out.chunk(2, dim=0)
        return e_u + self.t["guidance_scale"] * (e_c - e_u)

    def denoise(self, x, cond, uncond, lo: int, hi: int):
        for i in range(lo, hi):
            x, _ = ddim_step(self.sched, self.eps(x, i, cond, uncond), i, x)
        return x

    def energy(self, x0, target):
        img = self.vae.decode(x0)
        side = self.guide_side
        img = F.interpolate(img.permute(0, 3, 1, 2), size=(side, side), mode="bicubic",
                            align_corners=False, antialias=True).permute(0, 2, 3, 1)
        f = self.guide.features(img)
        e = self.g["gs"] * torch.linalg.vector_norm(f - self.gp[target], dim=-1)
        local = self.lp[target]                                   # [B, K, D]
        k = torch.einsum("bd,bkd->bk", f, local).argmax(dim=-1)
        chosen = local[torch.arange(local.shape[0], device=f.device), k]
        return e + self.g["ls"] * torch.linalg.vector_norm(f - chosen.detach(), dim=-1)

    def rollout_step(self, x, i: int, cond, uncond, target):
        x_next, x0 = ddim_step(self.sched, self.eps(x, i, cond, uncond), i, x)
        return x_next, self.energy(x0, target)

    def transform(self, lat, cond, uncond, target, gamma0, beta0):
        g0, g1 = self.window
        gamma = gamma0.detach().clone().requires_grad_(True)
        beta = beta0.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            x = lat * (1.0 + gamma) + beta
            score = 0.0
            for i in range(g0, g1):
                x, e = self.rollout_step(x, i, cond, uncond, target)
                score = score + e
            score = score / (g1 - g0)
            gg, gb = torch.autograd.grad(score.sum(), (gamma, beta))
        rho, c = self.g["rho"], self.g["constraint_value"]
        new = lat * (1.0 + gamma0 - rho * gg) + (beta0 - rho * gb)
        return torch.clamp(new, lat - c, lat + c).detach()

    # ---- one sample ----
    def images(self, latent, cond, uncond, target, noise, gamma0, beta0, at_g0=None):
        """Images in [0, 1], NHWC fp32, of a batch of source latents; in a
        guided recipe, ``at_g0`` (a list) receives the latents at g0, before
        the guidance step."""
        a = torch.tensor(self.sched.alphas[int(self.sched.timesteps[self.start])],
                         device=latent.device)
        x = a.sqrt() * latent + (1 - a).sqrt() * noise
        n = self.steps
        if self.window is None:
            x = self.denoise(x, cond, uncond, self.start, n)
        else:
            g0 = self.window[0]
            x = self.denoise(x, cond, uncond, self.start, g0)
            if at_g0 is not None:
                at_g0.append(x.detach().clone())
            x = self.transform(x, cond, uncond, target, gamma0, beta0)
            x = self.denoise(x, cond, uncond, g0, n)
        return torch.clamp(self.vae.decode(x) / 2.0 + 0.5, 0.0, 1.0)


def to_levels(images01: torch.Tensor) -> np.ndarray:
    """[0, 1] images -> the 8-bit values a PNG of them holds: x * 255 + 0.5,
    clipped to [0, 255], truncated."""
    return np.clip(images01.detach().float().cpu().numpy() * 255.0 + 0.5, 0, 255
                   ).astype(np.uint8)

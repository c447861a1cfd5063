"""End-to-end guided expansion pipeline (port of
``distdiff_tpu/sampling/pipeline.py``: ``ExpansionPipeline.create``,
``make_expand_fn`` and the pieces they use).

Noise cached latents to the img2img start, denoise with CFG, splice the
DistDiff guidance in at the window, decode to images in [0, 1]. Eager
PyTorch: the plain denoise runs without autograd, the guidance leg with it.

Precision: the UNet and VAE run in their config's dtype (bf16 at SD-1.5
geometry; ``cast_params_bf16`` also stores their weights in bf16); all
normalisation statistics and the scheduler tables are fp32; the guide
ResNet-50 and the energy run in fp32 (with TF32 off on CUDA, see
``device.disable_tf32``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from distdiff_tpu_torch.config import GuidanceConfig, PipelineConfig
from distdiff_tpu_torch.device import disable_tf32, resolve_device
from distdiff_tpu_torch.guidance.optimize import (
    GuidanceContext,
    direct_guidance,
    transform_guidance,
)
from distdiff_tpu_torch.models.guide.factory import GuideModel
from distdiff_tpu_torch.models.unet import UNet2DConditionModel
from distdiff_tpu_torch.models.vae import AutoencoderKL
from distdiff_tpu_torch.sampling.sampler import (
    SamplerConfig,
    denoise_range,
    img2img_init,
    make_eps_fn,
)
from distdiff_tpu_torch.schedulers import (
    DDIMSchedule,
    guidance_window,
    img2img_start_index,
    make_schedule,
)

def _clamp_window(guidance_type: str, start: int, g0: int, g1: int,
                  step_in_plan: bool = False, n: Optional[int] = None):
    """Clamp the guidance window to the img2img start index, as the
    reference's loop does: transform guidance whose trigger step falls
    before the start never runs; direct guidance runs the surviving steps.
    ``step_in_plan`` shifts the window to the first executed step instead.
    Returns (guided, g0, g1)."""
    period = g1 - g0
    if step_in_plan and g0 < start:
        g0 = start if n is None else min(start, n - period)
        return True, g0, g0 + period
    if guidance_type == "transform_guidance":
        if g0 < start:
            return False, g0, g1
        return True, g0, g1
    g0 = max(g0, start)
    return g0 < g1, g0, g1


def resize_bicubic(img: torch.Tensor, size: int) -> torch.Tensor:
    """NHWC bicubic resize matching ``jax.image.resize(..., "bicubic")``,
    which antialiases when it downsamples (Keys cubic, a = -0.5): torch's
    antialiased bicubic is that kernel; its default (antialias=False) is not."""
    y = F.interpolate(img.permute(0, 3, 1, 2), size=(size, size), mode="bicubic",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The reference's initialisers: lecun-normal (truncated at 2 sigma)
    kernels, zero biases, unit norm scales; BatchNorm running mean 0 and
    variance 1."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
        elif hasattr(m, "weight") and isinstance(m.weight, nn.Parameter) \
                and m.weight.ndim == 1:
            m.weight.fill_(1.0)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()


def cast_params_bf16(pipe: "ExpansionPipeline") -> None:
    """Store the UNet's and VAE's weights as bf16, in place. Normalisation
    statistics stay fp32 (computed from fp32 casts); the guide stays fp32."""
    pipe.unet.to(torch.bfloat16)
    pipe.vae.to(torch.bfloat16)


@dataclasses.dataclass
class ExpansionPipeline:
    config: PipelineConfig
    sampler_cfg: SamplerConfig
    guidance_cfg: GuidanceConfig
    sched: DDIMSchedule
    unet: UNet2DConditionModel
    vae: AutoencoderKL
    device: torch.device
    guide: Optional[GuideModel] = None
    global_protos: Optional[torch.Tensor] = None
    local_protos: Optional[torch.Tensor] = None
    strength: float = 0.5

    @staticmethod
    def create(
        config: PipelineConfig,
        sampler_cfg: SamplerConfig = SamplerConfig(),
        guidance_cfg: GuidanceConfig = GuidanceConfig(),
        guide: Optional[GuideModel] = None,
        global_protos=None,
        local_protos=None,
        strength: float = 0.5,
        seed: int = 0,
        device: Union[str, torch.device] = "cuda",
    ) -> "ExpansionPipeline":
        """Build the pipeline with seeded random UNet/VAE weights (load real
        or converted weights with ``load_state_dict`` afterwards)."""
        device = resolve_device(device)
        if device.type == "cuda":
            disable_tf32()
        if guidance_cfg.rollout_remat != "step":
            raise NotImplementedError(
                f"rollout_remat={guidance_cfg.rollout_remat!r}: only 'step' is ported")
        sched = make_schedule(config.num_inference_steps,
                              prediction_type=config.prediction_type)
        unet = UNet2DConditionModel(config.unet, device=device)
        vae = AutoencoderKL(config.vae, device=device)
        gen = torch.Generator(device=device).manual_seed(seed)
        for m in (unet, vae):
            init_weights(m, gen)
            m.requires_grad_(False)
            m.eval()

        def protos(p):
            return None if p is None else torch.as_tensor(
                p, dtype=torch.float32).to(device)

        return ExpansionPipeline(
            config=config, sampler_cfg=sampler_cfg, guidance_cfg=guidance_cfg,
            sched=sched, unet=unet, vae=vae, device=device, guide=guide,
            global_protos=protos(global_protos), local_protos=protos(local_protos),
            strength=strength,
        )

    # ---- building blocks ----
    def eps_fn(self) -> Callable:
        return make_eps_fn(self.unet, self.sampler_cfg)

    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents -> images in [-1, 1] (fp32, NHWC)."""
        return self.vae.decode(latents.float() / self.config.vae.scaling_factor)

    def guide_decode_fn(self, x0_latent: torch.Tensor) -> torch.Tensor:
        """pred_x0 latents -> guide-ready images: VAE decode, no
        denormalisation, bicubic resize to the guide's input size."""
        return resize_bicubic(self.decode_latents(x0_latent),
                              self.guidance_cfg.guide_input_size)

    def guide_encode_fn(self, images: torch.Tensor) -> torch.Tensor:
        if self.guide is None:
            raise ValueError("guidance requires a guide model")
        return self.guide.encode_image(images).float()

    def guidance_context(self) -> GuidanceContext:
        return GuidanceContext(
            sched=self.sched,
            eps_fn=self.eps_fn(),
            decode_fn=self.guide_decode_fn,
            encode_fn=self.guide_encode_fn,
            cfg=self.guidance_cfg,
            global_protos=self.global_protos,
            local_protos=self.local_protos,
        )

    def guidance_active(self) -> bool:
        """Whether the guidance window survives clamping to the img2img start
        under this pipeline's step plan and strength."""
        gcfg = self.guidance_cfg
        if gcfg.guidance_type not in ("transform_guidance", "direct_guidance"):
            return False
        start = img2img_start_index(self.sched, self.strength)
        g0, g1 = guidance_window(self.sched, gcfg.guidance_step, gcfg.guidance_period)
        guided, _, _ = _clamp_window(gcfg.guidance_type, start, g0, g1,
                                     step_in_plan=gcfg.step_in_plan,
                                     n=self.sched.num_inference_steps)
        return guided

    def draw_inputs(self, image_latents: torch.Tensor, generator: torch.Generator
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The expansion's random draws, in one place: img2img noise
        (standard normal, latents' shape), gamma0 (uniform [0, 1)) and beta0
        (standard normal), both ``[B, 1, 1, C]``."""
        b, c = image_latents.shape[0], image_latents.shape[-1]
        dev = image_latents.device
        noise = torch.randn(image_latents.shape, generator=generator, device=dev)
        gamma0 = torch.rand((b, 1, 1, c), generator=generator, device=dev)
        beta0 = torch.randn((b, 1, 1, c), generator=generator, device=dev)
        return noise, gamma0, beta0

    # ---- the hot path ----
    def make_expand_fn(self) -> Callable:
        """Build ``expand(image_latents, cond, uncond, targets, generator=None,
        *, noise=None, gamma0=None, beta0=None, return_aux=False)`` -> images
        ``[B, H, W, 3]`` in [0, 1].

        The random draws come from ``generator`` (``draw_inputs``), unless
        all three are handed in ready-made (a test seam for holding the port
        against the JAX package's own draws). With ``return_aux`` it returns
        ``(images, aux)``, where aux holds the guidance score, the gradient
        on gamma/beta and the latents before and after the update."""
        sched = self.sched
        eps_fn = self.eps_fn()
        gcfg = self.guidance_cfg
        start = img2img_start_index(sched, self.strength)
        n = sched.num_inference_steps
        guided = gcfg.guidance_type in ("transform_guidance", "direct_guidance")
        g0 = g1 = n
        if guided:
            g0, g1 = guidance_window(sched, gcfg.guidance_step, gcfg.guidance_period)
            guided, g0, g1 = _clamp_window(gcfg.guidance_type, start, g0, g1,
                                           step_in_plan=gcfg.step_in_plan, n=n)
        ctx = self.guidance_context() if guided else None

        @torch.no_grad()
        def expand(image_latents, cond, uncond, targets, generator=None, *,
                   noise=None, gamma0=None, beta0=None, return_aux=False):
            given = [t is not None for t in (noise, gamma0, beta0)]
            if not all(given):
                if any(given) or generator is None:
                    raise ValueError("pass a generator, or all of noise, "
                                     "gamma0 and beta0")
                noise, gamma0, beta0 = self.draw_inputs(image_latents, generator)
            aux: Dict[str, torch.Tensor] = {}
            latents, _ = img2img_init(sched, image_latents, noise, self.strength)
            if not guided:
                latents = denoise_range(sched, eps_fn, latents, cond, uncond, start, n)
            elif gcfg.guidance_type == "transform_guidance":
                # plain to the window, one affine optimisation at g0, then
                # plain from g0 (the trigger step denoises normally after
                # the update)
                latents = denoise_range(sched, eps_fn, latents, cond, uncond, start, g0)
                aux["latents_before"] = latents
                latents, score, (g_gamma, g_beta) = transform_guidance(
                    ctx, latents, cond, uncond, targets, g0, gamma0, beta0)
                aux.update(latents_after=latents, score=score,
                           grad_gamma=g_gamma, grad_beta=g_beta)
                latents = denoise_range(sched, eps_fn, latents, cond, uncond, g0, n)
            else:  # direct guidance advances [g0, g1) itself
                latents = denoise_range(sched, eps_fn, latents, cond, uncond, start, g0)
                latents, score = direct_guidance(ctx, latents, cond, uncond,
                                                 targets, (g0, g1))
                aux["score"] = score
                latents = denoise_range(sched, eps_fn, latents, cond, uncond, g1, n)
            img = self.decode_latents(latents)
            img = torch.clamp(img / 2.0 + 0.5, 0.0, 1.0)
            return (img, aux) if return_aux else img

        return expand

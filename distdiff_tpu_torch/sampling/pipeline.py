"""End-to-end guided expansion pipeline (port of
``distdiff_tpu/sampling/pipeline.py``: ``ExpansionPipeline.create``,
``encode_images``, ``encode_text``, ``encode_text_pair``,
``make_expand_fn``, ``SplitExpand`` and the pieces they use).

SD-1.x and SD-2.x condition on a text-context tensor; SDXL (a config with
``text_encoder_2``) on the ``{"ctx", "add"}`` dict of ``encode_text_pair``,
which every function here passes on as an opaque value
(``sampling/conditioning.py``).

Noise cached latents to the img2img start, denoise with CFG (DDIM or
DPM-Solver++(2M), ``config.scheduler``; DeepCache under
``config.deep_cache``; the int8 w8a8 UNet under ``config.int8``, in the
plain spans only), splice the DistDiff guidance in at the window,
decode to images in [0, 1]. Eager PyTorch: the plain denoise runs without
autograd, the guidance leg with it, its recompute placed by
``GuidanceConfig.rollout_remat``.

Precision: the UNet, VAE and text encoder run in their config's dtype (bf16
at SD-1.5 geometry; ``cast_params_bf16`` also stores their weights in
bf16); all normalisation statistics and the scheduler tables are fp32; the
guide ResNet-50 and the energy run in fp32 (with TF32 off on CUDA, see
``device.disable_tf32``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from distdiff_tpu_torch.config import GuidanceConfig, PipelineConfig
from distdiff_tpu_torch.device import disable_tf32, resolve_device
from distdiff_tpu_torch.guidance.optimize import (
    GuidanceContext,
    direct_guidance,
    transform_guidance,
)
from distdiff_tpu_torch.models.guide.factory import GuideModel
from distdiff_tpu_torch.models.init import build_diffusion_modules
from distdiff_tpu_torch.models.layers import with_remat
from distdiff_tpu_torch.models.text_encoder import CLIPTextEncoder
from distdiff_tpu_torch.models.unet import UNet2DConditionModel
from distdiff_tpu_torch.models.vae import AutoencoderKL
from distdiff_tpu_torch.ops.quant import int8_inference
from distdiff_tpu_torch.sampling.conditioning import cond_slice
from distdiff_tpu_torch.sampling.sampler import (
    SamplerConfig,
    denoise_range,
    img2img_init,
    make_eps_fn,
    text2img_init,
    unet_apply,
    with_offset_noise,
)
from distdiff_tpu_torch.sampling.sdxl import encode_text_pair
from distdiff_tpu_torch.schedulers import (
    DDIMSchedule,
    DPMSchedule,
    build_schedule,
    guidance_window,
    img2img_start_index,
)

# the rollout_remat modes whose rollout runs the UNet, or the VAE decoder,
# without its inner per-block checkpoints
UNET_NO_REMAT = ("step_nru", "step_nr")
DECODER_NO_REMAT = ("step_nr", "decode_nr", "tail_decode_nr")


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


def cast_params_bf16(pipe) -> None:
    """Store the UNet's, VAE's and text encoders' weights as bf16, in place.
    Normalisation statistics stay fp32 (computed from fp32 casts); the guide
    stays fp32."""
    for m in (pipe.unet, pipe.vae, pipe.text_encoder, pipe.text_encoder_2):
        if m is not None:
            m.to(torch.bfloat16)


@dataclasses.dataclass
class ExpansionPipeline:
    config: PipelineConfig
    sampler_cfg: SamplerConfig
    guidance_cfg: GuidanceConfig
    sched: DDIMSchedule
    unet: UNet2DConditionModel
    vae: AutoencoderKL
    text_encoder: CLIPTextEncoder
    device: torch.device
    # SDXL's second (OpenCLIP-bigG) text tower; None for SD-1.x and SD-2.x
    text_encoder_2: Optional[CLIPTextEncoder] = None
    guide: Optional[GuideModel] = None
    global_protos: Optional[torch.Tensor] = None
    local_protos: Optional[torch.Tensor] = None
    strength: float = 0.5
    offset_noise: bool = False

    @staticmethod
    def create(
        config: PipelineConfig,
        sampler_cfg: SamplerConfig = SamplerConfig(),
        guidance_cfg: GuidanceConfig = GuidanceConfig(),
        guide: Optional[GuideModel] = None,
        global_protos=None,
        local_protos=None,
        strength: float = 0.5,
        offset_noise: bool = False,
        seed: int = 0,
        device: Union[str, torch.device] = "cuda",
    ) -> "ExpansionPipeline":
        """Build the pipeline with seeded random UNet/VAE/text-encoder
        weights (load a diffusers checkpoint with
        ``weights.convert.load_sd_checkpoint`` or, for SDXL,
        ``load_sdxl_checkpoint``, or converted weights with
        ``load_state_dict``, afterwards). ``offset_noise`` adds the
        per-(sample, channel) offset to the img2img noise
        (``--offset_noise``)."""
        device = resolve_device(device)
        if device.type == "cuda":
            disable_tf32()
        sched = build_schedule(config.scheduler, config.num_inference_steps,
                               prediction_type=config.prediction_type)
        unet, vae, text_encoder, text_encoder_2 = build_diffusion_modules(config, device, seed)

        def protos(p):
            return None if p is None else torch.as_tensor(
                p, dtype=torch.float32).to(device)

        return ExpansionPipeline(
            config=config, sampler_cfg=sampler_cfg, guidance_cfg=guidance_cfg,
            sched=sched, unet=unet, vae=vae, text_encoder=text_encoder,
            text_encoder_2=text_encoder_2, device=device, guide=guide,
            global_protos=protos(global_protos), local_protos=protos(local_protos),
            strength=strength, offset_noise=offset_noise,
        )

    # ---- building blocks ----
    @property
    def is_sdxl(self) -> bool:
        return self.config.text_encoder_2 is not None

    def span_context(self):
        """The context of a plain-span UNet call: ``int8_inference()`` under
        ``config.int8`` (the w8a8 route of ``ops/quant.py``), else none."""
        return int8_inference() if self.config.int8 else contextlib.nullcontext()

    def eps_fn(self) -> Callable:
        """The CFG epsilon of the plain denoise spans, on the int8 route
        under ``config.int8``. The guidance leg builds its own, exact one
        (``guidance_context``), as the JAX package's ``eps_fn(exact=True)``."""
        def unet(x, t, ctx):
            with self.span_context():
                return unet_apply(self.unet, x, t, ctx)

        return make_eps_fn(unet, self.sampler_cfg)

    def cached_eps_fns(self) -> Tuple[Callable, Callable]:
        """(eps_full, eps_shallow) of the DeepCache loop at
        ``config.cache_branch``, both on the int8 route under
        ``config.int8``; the guidance rollout never takes them."""
        from distdiff_tpu_torch.sampling.deepcache import make_cached_eps_fns

        branch = self.config.cache_branch

        def unet_full(x, t, ctx):
            with self.span_context():
                return unet_apply(self.unet, x, t, ctx, return_cache=True, cache_branch=branch)

        def unet_shallow(x, t, ctx, cache):
            with self.span_context():
                return unet_apply(self.unet, x, t, ctx, deep_cache=cache, cache_branch=branch)

        return make_cached_eps_fns(unet_full, unet_shallow, self.sampler_cfg)

    def denoise_ranged(self) -> Callable:
        """``ranged(x, cond, uncond, lo, hi)``: the plain denoise of plan
        steps [lo, hi) that every expansion path takes, DeepCache's under
        ``config.deep_cache`` (DDIM only), else ``denoise_range`` (DDIM or
        DPM-Solver++ by the schedule)."""
        sched = self.sched
        if not self.config.deep_cache:
            eps_fn = self.eps_fn()

            def ranged(x, cond, uncond, lo, hi):
                return denoise_range(sched, eps_fn, x, cond, uncond, lo, hi)
            return ranged
        if isinstance(sched, DPMSchedule):
            raise NotImplementedError(
                "deep_cache composes with the DDIM solver only (config.scheduler='ddim')")
        from distdiff_tpu_torch.sampling.deepcache import denoise_range_cached

        eps_full, eps_shallow = self.cached_eps_fns()
        interval = self.config.cache_interval

        def ranged(x, cond, uncond, lo, hi):
            return denoise_range_cached(sched, eps_full, eps_shallow, x, cond, uncond,
                                        lo, hi, interval)
        return ranged

    @torch.no_grad()
    def encode_images(self, images: torch.Tensor,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[-1, 1] NHWC images -> scaled latents (the cached-latent
        convention): the posterior's mean, or a sample drawn with
        ``generator``, times the VAE's scaling factor."""
        return self.vae.encode(images, generator) * self.config.vae.scaling_factor

    @torch.no_grad()
    def encode_text(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Token ids ``[B, T]`` -> the text context ``[B, T, D]`` (fp32)."""
        return self.text_encoder(input_ids)

    def encode_text_pair(self, ids_1: torch.Tensor, ids_2: torch.Tensor,
                         time_ids: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """SDXL's ``{"ctx", "add"}`` conditioning (``sdxl.encode_text_pair``)."""
        if not self.is_sdxl:
            raise ValueError("encode_text_pair is SDXL's (config.text_encoder_2)")
        return encode_text_pair(self.text_encoder, self.text_encoder_2, self.config,
                                ids_1, ids_2, time_ids)

    def decode_latents(self, latents: torch.Tensor, vae=None) -> torch.Tensor:
        """Latents -> images in [-1, 1] (fp32, NHWC), through ``vae``
        (default: the pipeline's)."""
        vae = self.vae if vae is None else vae
        return vae.decode(latents.float() / self.config.vae.scaling_factor)

    def guide_decode_fn(self, x0_latent: torch.Tensor, vae=None) -> torch.Tensor:
        """pred_x0 latents -> guide-ready images: VAE decode, no
        denormalisation, bicubic resize to the guide's input size."""
        return resize_bicubic(self.decode_latents(x0_latent, vae),
                              self.guidance_cfg.guide_input_size)

    def guide_encode_fn(self, images: torch.Tensor) -> torch.Tensor:
        if self.guide is None:
            raise ValueError("guidance requires a guide model")
        return self.guide.encode_image(images).float()

    def guidance_context(self) -> GuidanceContext:
        """The rollout's functions for ``rollout_remat``: the "step_nru" and
        "step_nr" modes run the UNet, and "step_nr", "decode_nr" and
        "tail_decode_nr" the VAE decoder, without their inner checkpoints
        (views of the same modules, ``with_remat``)."""
        mode = self.guidance_cfg.rollout_remat
        unet = with_remat(self.unet, False) if mode in UNET_NO_REMAT else self.unet
        vae = with_remat(self.vae, False) if mode in DECODER_NO_REMAT else self.vae
        return GuidanceContext(
            sched=self.sched,
            eps_fn=make_eps_fn(functools.partial(unet_apply, unet), self.sampler_cfg),
            decode_fn=lambda z: self.guide_decode_fn(z, vae),
            encode_fn=self.guide_encode_fn,
            cfg=self.guidance_cfg,
            global_protos=self.global_protos,
            local_protos=self.local_protos,
        )

    def guidance_active(self, text_to_img: bool = False) -> bool:
        """Whether the guidance window survives clamping to the first
        executed step (the img2img start index, or 0 under ``text_to_img``)
        under this pipeline's step plan and strength."""
        return self.window(text_to_img)[2]

    def window(self, text_to_img: bool = False) -> Tuple[int, int, bool, int, int]:
        """(start, n, guided, g0, g1): the first executed plan index (the
        img2img start, or 0 under ``text_to_img``), the plan length, and
        the guidance window clamped to the start."""
        sched, gcfg = self.sched, self.guidance_cfg
        start = 0 if text_to_img else img2img_start_index(sched, self.strength)
        n = sched.num_inference_steps
        guided = gcfg.guidance_type in ("transform_guidance", "direct_guidance")
        g0 = g1 = n
        if guided:
            g0, g1 = guidance_window(sched, gcfg.guidance_step, gcfg.guidance_period)
            guided, g0, g1 = _clamp_window(gcfg.guidance_type, start, g0, g1,
                                           step_in_plan=gcfg.step_in_plan, n=n)
        return start, n, guided, g0, g1

    def draw_unit_inputs(self, image_latents: torch.Tensor,
                         generators: Sequence[torch.Generator], text_to_img: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``draw_inputs`` with one generator per sample (per work unit), so
        that a sample's draws do not depend on the batch it is in."""
        draws = [self.draw_inputs(image_latents[i:i + 1], g, text_to_img)
                 for i, g in enumerate(generators)]
        return tuple(torch.cat(d, dim=0) for d in zip(*draws))

    def make_split_expand(self, text_to_img: bool = False, guide_chunk: Optional[int] = None,
                          decode_chunk: Optional[int] = None) -> "SplitExpand":
        """The expansion as its three parts (see ``SplitExpand``), with the
        guidance update and the final span + decode run on sub-batches of
        ``guide_chunk`` and ``decode_chunk`` samples."""
        return SplitExpand(self, text_to_img=text_to_img, guide_chunk=guide_chunk,
                           decode_chunk=decode_chunk)

    def draw_inputs(self, image_latents: torch.Tensor, generator: torch.Generator,
                    text_to_img: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The expansion's random draws, in one place: img2img noise
        (standard normal, latents' shape), gamma0 (uniform [0, 1)) and beta0
        (standard normal), both ``[B, 1, 1, C]``. With the pipeline's
        ``offset_noise``, and not under ``text_to_img``, one more
        standard-normal draw per (sample, channel), made after the others so
        that they do not move, is added to the noise (``with_offset_noise``)."""
        b, c = image_latents.shape[0], image_latents.shape[-1]
        dev = image_latents.device
        noise = torch.randn(image_latents.shape, generator=generator, device=dev)
        gamma0 = torch.rand((b, 1, 1, c), generator=generator, device=dev)
        beta0 = torch.randn((b, 1, 1, c), generator=generator, device=dev)
        if self.offset_noise and not text_to_img:
            offset = torch.randn((b, 1, 1, c), generator=generator, device=dev)
            noise = with_offset_noise(noise, offset)
        return noise, gamma0, beta0

    def draw(self, image_latents: torch.Tensor, generators, text_to_img: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The draws of one expand call, from one ``torch.Generator`` for the
        batch (``draw_inputs``) or one per sample (``draw_unit_inputs``, as
        ``ExpansionDriver`` passes them)."""
        if isinstance(generators, torch.Generator):
            return self.draw_inputs(image_latents, generators, text_to_img)
        return self.draw_unit_inputs(image_latents, generators, text_to_img)

    def init_latents(self, image_latents: torch.Tensor, noise: torch.Tensor,
                     text_to_img: bool = False) -> torch.Tensor:
        """The trajectory's first latents: the img2img-noised cached
        latents, or under ``text_to_img`` the fp32 noise itself
        (``image_latents`` then gives only the shape)."""
        if text_to_img:
            return text2img_init(noise)[0]
        return img2img_init(self.sched, image_latents, noise, self.strength)[0]

    # ---- the hot path ----
    def make_expand_fn(self, text_to_img: bool = False) -> Callable:
        """Build ``expand(image_latents, cond, uncond, targets, generator=None,
        *, noise=None, gamma0=None, beta0=None, return_aux=False)`` -> images
        ``[B, H, W, 3]`` in [0, 1].

        ``text_to_img`` starts from pure noise over the whole step plan (the
        reference's ``--text_to_img``); the offset of ``offset_noise`` is
        not applied then. The random draws come from ``generator``, one for
        the batch or one per sample (``draw``), unless all three are handed
        in ready-made (a test seam for holding the port against the JAX
        package's own draws; ``noise`` is then the whole noise, offset
        included, and under ``text_to_img`` the initial latents). With
        ``return_aux`` it returns ``(images, aux)``, where aux holds the
        guidance score, the gradient on gamma/beta and the latents before
        and after the update."""
        ranged = self.denoise_ranged()
        gcfg = self.guidance_cfg
        start, n, guided, g0, g1 = self.window(text_to_img)
        ctx = self.guidance_context() if guided else None

        @torch.no_grad()
        def expand(image_latents, cond, uncond, targets, generator=None, *,
                   noise=None, gamma0=None, beta0=None, return_aux=False):
            given = [t is not None for t in (noise, gamma0, beta0)]
            if not all(given):
                if any(given) or generator is None:
                    raise ValueError("pass a generator, or all of noise, "
                                     "gamma0 and beta0")
                noise, gamma0, beta0 = self.draw(image_latents, generator, text_to_img)
            aux: Dict[str, torch.Tensor] = {}
            latents = self.init_latents(image_latents, noise, text_to_img)
            if not guided:
                latents = ranged(latents, cond, uncond, start, n)
            elif gcfg.guidance_type == "transform_guidance":
                # plain to the window, one affine optimisation at g0, then
                # plain from g0 (the trigger step denoises normally after
                # the update)
                latents = ranged(latents, cond, uncond, start, g0)
                aux["latents_before"] = latents
                latents, score, (g_gamma, g_beta) = transform_guidance(
                    ctx, latents, cond, uncond, targets, g0, gamma0, beta0)
                aux.update(latents_after=latents, score=score,
                           grad_gamma=g_gamma, grad_beta=g_beta)
                latents = ranged(latents, cond, uncond, g0, n)
            else:  # direct guidance advances [g0, g1) itself
                latents = ranged(latents, cond, uncond, start, g0)
                latents, score = direct_guidance(ctx, latents, cond, uncond,
                                                 targets, (g0, g1))
                aux["score"] = score
                latents = ranged(latents, cond, uncond, g1, n)
            img = self.decode_latents(latents)
            img = torch.clamp(img / 2.0 + 0.5, 0.0, 1.0)
            return (img, aux) if return_aux else img

        return expand


class SplitExpand:
    """The expansion as three parts (port of the reference's ``SplitExpand``,
    single device): init + the plain span to the window, the guidance
    update, then the span from the window + the decode.

    ``guide_chunk`` runs the guidance update, and ``decode_chunk`` the final
    span + decode, on sub-batches of that many samples; samples are
    independent, so the result is the same, and the peak memory of the
    guidance backward (or of the 512^2 decode) falls with the chunk.

    The random draws come from one ``torch.Generator`` per sample
    (``draw_unit_inputs``), in place of the reference's per-sample threefry
    keys, so a sample's image does not depend on the batch it was in; or
    all of noise, gamma0 and beta0 are handed in, as to ``make_expand_fn``.
    ``text_to_img`` starts from pure noise, as in ``make_expand_fn``.
    """

    def __init__(self, pipe: ExpansionPipeline, text_to_img: bool = False,
                 guide_chunk: Optional[int] = None, decode_chunk: Optional[int] = None):
        self.pipe = pipe
        self.text_to_img = text_to_img
        self.guide_chunk = guide_chunk
        self.decode_chunk = decode_chunk
        self.start, self.n, self.guided, self.g0, self.g1 = pipe.window(text_to_img)
        self.ranged = pipe.denoise_ranged()
        self.ctx = pipe.guidance_context() if self.guided else None
        transform = pipe.guidance_cfg.guidance_type == "transform_guidance"
        self.resume = self.g0 if transform else self.g1

    @staticmethod
    def _chunks(b: int, chunk: Optional[int]):
        c = b if chunk is None or chunk >= b else chunk
        if b % c:
            raise ValueError(f"batch {b} is not a multiple of the chunk {c}")
        return [(i, i + c) for i in range(0, b, c)]

    def _span(self, x, cond, uncond, lo, hi):
        return self.ranged(x, cond, uncond, lo, hi)

    def init_span(self, image_latents, cond, uncond, noise, hi):
        """img2img noising (or pure noise), then plain steps [start, hi)."""
        x = self.pipe.init_latents(image_latents, noise, self.text_to_img)
        return self._span(x, cond, uncond, self.start, hi)

    def guide(self, x, cond, uncond, targets, gamma0, beta0):
        """The guidance update on one (sub-)batch."""
        if self.pipe.guidance_cfg.guidance_type == "transform_guidance":
            return transform_guidance(self.ctx, x, cond, uncond, targets, self.g0,
                                      gamma0, beta0)[0]
        return direct_guidance(self.ctx, x, cond, uncond, targets, (self.g0, self.g1))[0]

    def span_decode(self, x, cond, uncond, lo):
        """Plain steps [lo, n), then the decode to images in [0, 1]."""
        x = self._span(x, cond, uncond, lo, self.n)
        return torch.clamp(self.pipe.decode_latents(x) / 2.0 + 0.5, 0.0, 1.0)

    @torch.no_grad()
    def __call__(self, image_latents, cond, uncond, targets,
                 generators: Optional[Sequence[torch.Generator]] = None, *,
                 noise=None, gamma0=None, beta0=None) -> torch.Tensor:
        given = [t is not None for t in (noise, gamma0, beta0)]
        if not all(given):
            if any(given) or generators is None:
                raise ValueError("pass one generator per sample, or all of noise, "
                                 "gamma0 and beta0")
            if len(generators) != image_latents.shape[0]:
                raise ValueError(f"{len(generators)} generators for a batch of "
                                 f"{image_latents.shape[0]}")
            noise, gamma0, beta0 = self.pipe.draw(image_latents, generators, self.text_to_img)
        b = image_latents.shape[0]
        if not self.guided:
            x = self.init_span(image_latents, cond, uncond, noise, self.start)
            lo = self.start
        else:
            x = self.init_span(image_latents, cond, uncond, noise, self.g0)
            x = torch.cat([
                self.guide(x[i:j], cond_slice(cond, i, j), cond_slice(uncond, i, j),
                           targets[i:j], gamma0[i:j], beta0[i:j])
                for i, j in self._chunks(b, self.guide_chunk)], dim=0)
            lo = self.resume
        return torch.cat([
            self.span_decode(x[i:j], cond_slice(cond, i, j), cond_slice(uncond, i, j), lo)
            for i, j in self._chunks(b, self.decode_chunk)], dim=0)

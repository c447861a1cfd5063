"""SDXL-base text-to-image and img2img (port of
``distdiff_tpu/sampling/sdxl.py``): the dual text towers and the additive
conditioning.

* The context is CLIP-L's penultimate hidden state (768) beside
  OpenCLIP-bigG's (1280): ``[B, T, 2048]``.
* The additive vector is bigG's projected pooled embedding beside the
  sinusoidal embedding of the six micro-conditioning ids (original height
  and width, crop top and left, target height and width), 256 wide each:
  ``[B, 2816]``, through the UNet's ``add_embedding``.
* The denoise is ``sampler.denoise_range`` with CFG, so DDIM and
  DPM-Solver++ dispatch as on SD-1.x (the UNet on the int8 route of
  ``ops/quant.py`` under ``config.int8``), then the VAE decode.

``encode_text_pair`` gives the ``{"ctx", "add"}`` conditioning, to
``SDXLPipeline.encode_prompt`` and to ``ExpansionPipeline.encode_text_pair``,
through which the guided expansion on SDXL goes.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Union

import torch

from distdiff_tpu_torch.config import PipelineConfig
from distdiff_tpu_torch.device import disable_tf32, resolve_device
from distdiff_tpu_torch.models.init import build_diffusion_modules
from distdiff_tpu_torch.models.layers import timestep_embedding
from distdiff_tpu_torch.models.text_encoder import CLIPTextEncoder
from distdiff_tpu_torch.models.unet import UNet2DConditionModel
from distdiff_tpu_torch.models.vae import AutoencoderKL
from distdiff_tpu_torch.ops.quant import int8_inference
from distdiff_tpu_torch.sampling.sampler import (
    SamplerConfig,
    denoise_range,
    img2img_init,
    make_eps_fn,
    text2img_init,
    unet_apply,
    with_offset_noise,
)
from distdiff_tpu_torch.schedulers import DDIMSchedule, build_schedule, img2img_start_index


def time_ids_embedding(time_ids: torch.Tensor, dim_per_id: int = 256) -> torch.Tensor:
    """``[B, 6]`` micro-conditioning ids -> ``[B, 6 * dim_per_id]``
    sinusoidal embeddings (diffusers' ``add_time_proj``; the timesteps'
    ``[cos | sin]`` convention)."""
    b, k = time_ids.shape
    return timestep_embedding(time_ids.reshape(-1), dim_per_id).reshape(b, k * dim_per_id)


def default_time_ids(batch: int, size: int, device=None) -> torch.Tensor:
    """(original size, crop 0 0, target size) of a square image at ``size``."""
    row = torch.tensor([size, size, 0, 0, size, size], dtype=torch.float32, device=device)
    return row.expand(batch, 6)


@torch.no_grad()
def encode_text_pair(text_encoder: CLIPTextEncoder, text_encoder_2: CLIPTextEncoder,
                     config: PipelineConfig, ids_1: torch.Tensor, ids_2: torch.Tensor,
                     time_ids: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """SDXL's conditioning from the two tokenizations of the prompts:
    ``{"ctx": [B, T, D1 + D2], "add": [B, addition_embed_dim]}``, the two
    towers' penultimate states side by side, and bigG's projected pooled
    embedding beside the time-id embedding (``time_ids`` default to a
    square image at ``config.sample_size``)."""
    h1 = text_encoder.penultimate_hidden(ids_1)
    h2, pooled = text_encoder_2.sdxl_outputs(ids_2)
    if time_ids is None:
        time_ids = default_time_ids(pooled.shape[0], config.sample_size, pooled.device)
    dim = (config.unet.addition_embed_dim - pooled.shape[-1]) // 6
    add = torch.cat([pooled.float(), time_ids_embedding(time_ids.float(), dim)], dim=-1)
    return {"ctx": torch.cat([h1, h2], dim=-1), "add": add}


@dataclasses.dataclass
class SDXLPipeline:
    """SDXL text-to-image and img2img with the additive-conditioning UNet."""

    config: PipelineConfig
    sampler_cfg: SamplerConfig
    sched: DDIMSchedule
    unet: UNet2DConditionModel
    vae: AutoencoderKL
    text_encoder: CLIPTextEncoder     # CLIP-L
    text_encoder_2: CLIPTextEncoder   # OpenCLIP-bigG, projected
    device: torch.device
    strength: float = 0.5
    offset_noise: bool = False

    @staticmethod
    def create(config: Optional[PipelineConfig] = None,
               sampler_cfg: SamplerConfig = SamplerConfig(), strength: float = 0.5,
               offset_noise: bool = False, seed: int = 0, lazy_params: bool = False,
               device: Union[str, torch.device] = "cuda") -> "SDXLPipeline":
        """Seeded random weights (load a diffusers SDXL checkpoint with
        ``weights.convert.load_sdxl_checkpoint`` afterwards), or with
        ``lazy_params`` a bf16 constant fill (``build_diffusion_modules``)."""
        config = config or PipelineConfig.sdxl_base()
        device = resolve_device(device)
        if device.type == "cuda":
            disable_tf32()
        if config.text_encoder_2 is None:
            raise ValueError("SDXL needs config.text_encoder_2")
        unet, vae, te1, te2 = build_diffusion_modules(config, device, seed, lazy_params)
        return SDXLPipeline(
            config=config, sampler_cfg=sampler_cfg,
            sched=build_schedule(config.scheduler, config.num_inference_steps,
                                 prediction_type=config.prediction_type),
            unet=unet, vae=vae, text_encoder=te1, text_encoder_2=te2, device=device,
            strength=strength, offset_noise=offset_noise)

    def encode_prompt(self, ids_1: torch.Tensor, ids_2: torch.Tensor,
                      time_ids: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The ``{"ctx", "add"}`` conditioning of ``encode_text_pair``."""
        return encode_text_pair(self.text_encoder, self.text_encoder_2, self.config,
                                ids_1, ids_2, time_ids)

    def make_sample_fn(self, text_to_img: bool = True) -> Callable:
        """``sample(latents, cond, uncond, generator=None, *, noise=None)``
        -> images ``[B, H, W, 3]`` in [0, 1], on the ``{"ctx", "add"}``
        conds of ``encode_prompt``. ``latents`` are the img2img source
        (scaled latents), or under ``text_to_img`` give only the shape. The noise is drawn from
        ``generator`` (standard normal, then under ``offset_noise`` and
        img2img one more draw per (sample, channel)), or handed in whole."""
        sched = self.sched
        start = 0 if text_to_img else img2img_start_index(sched, self.strength)
        n = sched.num_inference_steps
        span = int8_inference if self.config.int8 else contextlib.nullcontext

        def unet(x, t, ctx):
            with span():  # the w8a8 route of ops/quant.py under config.int8
                return unet_apply(self.unet, x, t, ctx)

        eps_fn = make_eps_fn(unet, self.sampler_cfg)

        @torch.no_grad()
        def sample(latents, cond, uncond, generator=None, *, noise=None):
            if noise is None:
                if generator is None:
                    raise ValueError("pass a generator or the noise")
                noise = torch.randn(latents.shape, generator=generator, device=latents.device)
                if self.offset_noise and not text_to_img:
                    b, c = latents.shape[0], latents.shape[-1]
                    offset = torch.randn((b, 1, 1, c), generator=generator,
                                         device=latents.device)
                    noise = with_offset_noise(noise, offset)
            if text_to_img:
                x = text2img_init(noise)[0]
            else:
                x = img2img_init(sched, latents, noise, self.strength)[0]
            x = denoise_range(sched, eps_fn, x, cond, uncond, start, n)
            img = self.vae.decode(x.float() / self.config.vae.scaling_factor)
            return torch.clamp(img / 2.0 + 0.5, 0.0, 1.0)

        return sample

"""Weight initialisation shared by the diffusion models and the guide
classifier: the flax initialisers the JAX package's modules are built with."""

from __future__ import annotations

import math

import torch
import torch.nn as nn


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The reference's initialisers: lecun-normal (truncated at 2 sigma)
    kernels, zero biases, unit norm scales; BatchNorm running mean 0 and
    variance 1; embeddings, and the raw parameters a module names in
    ``NORMAL_PARAMS`` (the CLIP ViT's), normal with std 0.02."""
    for m in module.modules():
        if isinstance(m, nn.Embedding):
            nn.init.normal_(m.weight, std=0.02, generator=generator)
        elif isinstance(m, (nn.Conv2d, nn.Linear)):
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
        for name in getattr(m, "NORMAL_PARAMS", ()):
            nn.init.normal_(getattr(m, name), std=0.02, generator=generator)


# the value every floating tensor of build_diffusion_modules(lazy=True) holds
LAZY_FILL = 0.02


def build_diffusion_modules(config, device: torch.device, seed: int = 0, lazy: bool = False):
    """(unet, vae, text_encoder, text_encoder_2) of a ``PipelineConfig``,
    frozen and in eval mode; ``text_encoder_2`` (SDXL's bigG tower) is None
    unless the config has one. Seeded random weights from one generator, in
    that order; or with ``lazy`` every floating tensor bf16 and filled with
    ``LAZY_FILL``, for timing runs where the values do not matter: the
    modules are built and cast on the meta device, so only the bf16 tensors
    are ever allocated."""
    from distdiff_tpu_torch.models.text_encoder import CLIPTextEncoder
    from distdiff_tpu_torch.models.unet import UNet2DConditionModel
    from distdiff_tpu_torch.models.vae import AutoencoderKL

    where = "meta" if lazy else device
    t2 = config.text_encoder_2
    mods = (UNet2DConditionModel(config.unet, device=where),
            AutoencoderKL(config.vae, device=where),
            CLIPTextEncoder(config.text_encoder, device=where),
            None if t2 is None else CLIPTextEncoder(t2, device=where))
    gen = None if lazy else torch.Generator(device=device).manual_seed(seed)
    for m in (m for m in mods if m is not None):
        if lazy:
            m.to(torch.bfloat16).to_empty(device=device)
            with torch.no_grad():
                for t in list(m.parameters()) + list(m.buffers()):
                    if t.is_floating_point():
                        t.fill_(LAZY_FILL)
        else:
            init_weights(m, gen)
        m.requires_grad_(False)
        m.eval()
    return mods

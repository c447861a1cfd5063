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
    variance 1; embeddings normal with std 0.02."""
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

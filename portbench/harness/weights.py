"""Seeded weights and inputs of a cell, made on the device in a few large
calls and handed alike to the program and to the reference.

The parameter names and shapes come from the reference modules built on the
meta device (diffusers' and torchvision's names). Each module's floating
tensors are one ``torch.randn`` of their total size, in the type they are
served in (the UNet and the VAE in the configuration's dtype, the guide in
fp32), cut into views and scaled in place: kernels (two or more dimensions)
by 1/sqrt(fan-in), biases by 0.1, norm scales to 1 + 0.1 x; BatchNorm's
running statistics are 0 and 1. The same seed gives the same values, so the
reference remakes them after the program's run instead of keeping a copy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch

from portbench.reference import models
from portbench.reference.layers import timestep_embedding

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}
# sub-seeds of --seed, one per stream of draws
PARTS = {"unet": 1, "vae": 2, "guide": 3, "inputs": 4, "sample": 5}


def sub_seed(seed: int, part: str) -> int:
    """A 63-bit seed for ``part`` from the run's ``--seed`` (any size)."""
    state = np.random.SeedSequence([abs(int(seed)), PARTS[part]]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def served_dtype(cfg: dict, part: str) -> torch.dtype:
    return torch.float32 if part == "guide" else DTYPES[cfg["dtype"]]


@torch.no_grad()
def make_state(module: torch.nn.Module, seed: int, dtype: torch.dtype,
               device) -> Dict[str, torch.Tensor]:
    """The seeded state dict of ``module`` (its names and shapes)."""
    spec = module.state_dict()
    floats = [(k, v.shape) for k, v in spec.items() if v.is_floating_point()]
    total = sum(math.prod(s) for _, s in floats)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, off = {}, 0
    for k, shape in floats:
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        off += n
        if len(shape) >= 2:
            t.mul_(1.0 / math.sqrt(n // shape[0]))
        elif k.endswith("running_mean"):
            t.zero_()
        elif k.endswith("running_var"):
            t.fill_(1.0)
        elif k.endswith("bias"):
            t.mul_(0.1)
        else:
            t.mul_(0.1).add_(1.0)
        out[k] = t
    for k, v in spec.items():
        if not v.is_floating_point():
            out[k] = torch.zeros(v.shape, dtype=v.dtype, device=device)
    return out


def states(cfg: dict, seed: int, device, mods=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"unet", "vae", "guide"}: each seeded state dict, in its served type."""
    mods = models.build(cfg) if mods is None else mods
    return {p: make_state(m, sub_seed(seed, p), served_dtype(cfg, p), device)
            for p, m in mods.items()}


@dataclasses.dataclass
class Inputs:
    """What the CLI holds after set-up, and the draws of every work unit."""
    latents: np.ndarray            # [items, h, w, 4] fp32, scaled VAE latents
    cond: object                   # per class: [classes, T, D], or SDXL's dict
    uncond: object                 # [T, D], or SDXL's dict
    labels: list                   # class of each item
    global_protos: torch.Tensor    # [classes, F] fp32, unit rows
    local_protos: torch.Tensor     # [classes, K, F] fp32, unit rows
    noise: torch.Tensor            # [units, h, w, 4] fp32, unit = item * per_prompt + i
    gamma0: torch.Tensor           # [units, 1, 1, 4] uniform [0, 1)
    beta0: torch.Tensor            # [units, 1, 1, 4] standard normal
    per_prompt: int

    def unit_draws(self, ordinals):
        idx = torch.as_tensor(list(ordinals), device=self.noise.device)
        return tuple(t.index_select(0, idx) for t in (self.noise, self.gamma0, self.beta0))

    def cond_of(self, cls: int):
        if isinstance(self.cond, dict):
            return {k: v[cls] for k, v in self.cond.items()}
        return self.cond[cls]


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


@torch.no_grad()
def make_inputs(cfg: dict, traffic: dict, seed: int, device) -> Inputs:
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "inputs"))

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    classes = traffic["classes"]
    items = classes * traffic["items_per_class"]
    per = traffic["images_per_prompt"]
    side = cfg["sample_size"] // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    lc = cfg["vae"]["latent_channels"]
    text = cfg["text"]
    latents = randn(items, side, side, lc)
    ctx = randn(classes + 1, text["context_length"], text["context_width"])
    if "pooled_width" in text:  # SDXL: [pooled | sinusoid of the time ids]
        ids = torch.tensor(text["time_ids"], dtype=torch.float32, device=device)
        dim = (cfg["unet"]["projection_class_embeddings_input_dim"]
               - text["pooled_width"]) // len(text["time_ids"])
        tid = timestep_embedding(ids, dim).reshape(1, -1)
        add = torch.cat([randn(classes + 1, text["pooled_width"]),
                         tid.expand(classes + 1, -1)], dim=-1)
        cond = {"ctx": ctx[:classes].cpu().numpy(), "add": add[:classes].cpu().numpy()}
        uncond = {"ctx": ctx[classes].cpu().numpy(), "add": add[classes].cpu().numpy()}
    else:
        cond, uncond = ctx[:classes].cpu().numpy(), ctx[classes].cpu().numpy()
    guide = cfg["guide"]
    fdim = guide["base_width"] * 2 ** (len(guide["stage_sizes"]) - 1) * 4
    k = traffic["guidance"]["K"]
    gp = _unit_rows(randn(classes, fdim))
    lp = _unit_rows(randn(classes, k, fdim))
    units = items * per
    noise = randn(units, side, side, lc)
    gamma0 = torch.rand((units, 1, 1, lc), generator=gen, device=device)
    beta0 = randn(units, 1, 1, lc)
    return Inputs(latents=latents.cpu().numpy(), cond=cond, uncond=uncond,
                  labels=[i % classes for i in range(items)], global_protos=gp,
                  local_protos=lp, noise=noise, gamma0=gamma0, beta0=beta0, per_prompt=per)

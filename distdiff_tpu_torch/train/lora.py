"""LoRA fine-tuning of the diffusion UNet (port of
``distdiff_tpu/train/lora.py``).

The adapter is a separate flat dict ``{JAX leaf path: {"a": [in, r], "b":
[r, out]}}`` over the UNet's targeted 2-D Dense kernels (default: the
attention projections ``to_q``/``to_k``/``to_v``/``to_out``), keyed and laid
out as the JAX package's, so that an adapter file (``save_lora``'s ``.npz``)
trained by either package applies in the other. Each leaf's path and rank
are the JAX package's: the port's state-dict name goes through its copy of
``map_unet_key`` and the layout transform (``weights/from_jax.py``), so
SD-1.x's ``proj_in``/``proj_out`` (a 2-D Dense in JAX, a ``[C, C, 1, 1]``
convolution here) are targets under ``--targets proj`` in both packages.

``W_eff = W + (alpha/r) (a @ b)^T`` in the port's ``[out, in]`` layout
(``[O, I, 1, 1]`` for a 1x1 convolution), summed in fp32 and stored in
``W``'s dtype. ``apply_lora`` puts the merged weights in place of the
adapted parameters for the span of a ``with`` block, differentiably in
``a`` and ``b``: the forward and ``backward()`` both run inside it, so
that the UNet's inner checkpoints (``models/layers.py`` ``remat_call``),
which recompute each block during the backward, read the same merged
weights. ``merge_lora`` writes them into the parameters once, for serving.

The objective is the denoising loss on VAE latents: ``mean((pred -
target)^2)`` in fp32 at uniformly drawn training timesteps, the target the
noise, or under v-prediction ``sqrt(a) noise - sqrt(1 - a) x0``. The base
weights keep ``requires_grad`` off; gradients reach ``a`` and ``b`` only.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from distdiff_tpu_torch.schedulers.ddim import DDIMSchedule, add_noise, alphas_at
from distdiff_tpu_torch.weights.from_jax import jax_leaf

DEFAULT_TARGETS: Tuple[str, ...] = ("to_q", "to_k", "to_v", "to_out")

Lora = Dict[str, Dict[str, torch.Tensor]]


@functools.lru_cache(maxsize=None)
def _leaf(name: str, shape: Tuple[int, ...]) -> Tuple[Optional[str], Tuple[int, ...]]:
    return jax_leaf("unet", name, shape)


def _is_target(names: List[str], ndim: int, targets: Iterable[str]) -> bool:
    """The JAX package's rule on a leaf's path and rank: a 2-D ``kernel``
    whose parent (or grandparent, for wrappers like ``ff/net_0/proj``)
    equals a target or starts with one."""
    if not names or names[-1] != "kernel" or ndim != 2:
        return False
    targets = tuple(targets)
    for up in (2, 3):
        if len(names) >= up:
            parent = names[-up]
            if any(parent == t or parent.startswith(t) for t in targets):
                return True
    return False


def lora_table(unet: torch.nn.Module,
               targets: Iterable[str] = DEFAULT_TARGETS) -> Dict[str, Tuple[str, Tuple[int, int]]]:
    """JAX leaf path -> (the port's parameter name, JAX ``(in, out)``
    shape) of each leaf LoRA adapts."""
    targets = tuple(targets)
    table = {}
    for name, p in unet.named_parameters():
        path, jshape = _leaf(name, tuple(p.shape))
        if path is not None and _is_target(path.split("/"), len(jshape), targets):
            table[path] = (name, jshape)
    return table


def lora_keys(unet: torch.nn.Module, targets: Iterable[str] = DEFAULT_TARGETS) -> List[str]:
    """Sorted JAX leaf paths LoRA will adapt."""
    return sorted(lora_table(unet, targets))


def init_lora(generator: torch.Generator, unet: torch.nn.Module, rank: int = 4,
              targets: Iterable[str] = DEFAULT_TARGETS, dtype=torch.float32) -> Lora:
    """The adapter: ``a ~ N(0, 1/rank)`` drawn from ``generator`` leaf by
    leaf in key order, ``b = 0`` (the identity at the start), on the UNet's
    device, each tensor requiring grad."""
    table = lora_table(unet, targets)
    if not table:
        raise ValueError(f"no LoRA targets matched {tuple(targets)}")
    device = next(unet.parameters()).device
    lora: Lora = {}
    for key in sorted(table):
        n_in, n_out = table[key][1]
        a = torch.randn((n_in, rank), generator=generator, dtype=dtype,
                        device=generator.device) / math.sqrt(rank)
        lora[key] = {"a": a.to(device).requires_grad_(),
                     "b": torch.zeros((rank, n_out), dtype=dtype, device=device,
                                      requires_grad=True)}
    return lora


def merged_weight(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  alpha: float) -> torch.Tensor:
    """``(w.float() + (alpha/r) (a @ b)^T).to(w.dtype)``, ``(a @ b)^T``
    reshaped to ``w``'s layout (``[out, in]`` or ``[O, I, 1, 1]``)."""
    delta = (a.float() @ b.float()) * (alpha / a.shape[1])
    return (w.float() + delta.t().reshape(w.shape)).to(w.dtype)


def _resolve(unet: torch.nn.Module, lora: Lora) -> List[Tuple[str, torch.nn.Module, str]]:
    """(key, module, parameter name) of each adapted leaf; a ``KeyError``
    for a key with no leaf in ``unet``."""
    names = {_leaf(n, tuple(p.shape))[0]: n for n, p in unet.named_parameters()}
    missing = sorted(set(lora) - set(names))
    if missing:
        raise KeyError(f"LoRA leaves not found in the UNet: {missing}")
    out = []
    for key in lora:
        mod_name, _, pname = names[key].rpartition(".")
        out.append((key, unet.get_submodule(mod_name), pname))
    return out


@contextlib.contextmanager
def apply_lora(unet: torch.nn.Module, lora: Lora, alpha: float = 1.0):
    """Within the block, each adapted parameter of ``unet`` is replaced by
    its merged weight (a tensor differentiable in ``a`` and ``b``); on
    leaving, the parameters are put back. Run the forward and its
    ``backward()`` inside one block: the inner checkpoints recompute their
    blocks from the merged weights during the backward."""
    swapped = []
    try:
        for key, mod, pname in _resolve(unet, lora):
            w = mod._parameters[pname]
            mod._parameters[pname] = merged_weight(w, lora[key]["a"], lora[key]["b"], alpha)
            swapped.append((mod, pname, w))
        yield unet
    finally:
        for mod, pname, w in reversed(swapped):
            mod._parameters[pname] = w


@torch.no_grad()
def merge_lora(unet: torch.nn.Module, lora: Lora, alpha: float = 1.0) -> torch.nn.Module:
    """Write the merged weights into ``unet``'s parameters, in place (the
    adapter baked in for serving); returns ``unet``."""
    for key, mod, pname in _resolve(unet, lora):
        w = mod._parameters[pname]
        w.copy_(merged_weight(w, lora[key]["a"].to(w.device), lora[key]["b"].to(w.device),
                              alpha))
    return unet


# ------------------------------------------------------------- persistence

def save_lora(path: str, lora: Lora, alpha: float = 1.0) -> None:
    """The JAX package's ``.npz``: ``"<leaf path>::a"`` ``[in, r]``,
    ``"::b"`` ``[r, out]`` and ``__alpha__``."""
    arrs = {"__alpha__": np.float32(alpha)}
    for key, pair in lora.items():
        arrs[f"{key}::a"] = pair["a"].detach().cpu().numpy()
        arrs[f"{key}::b"] = pair["b"].detach().cpu().numpy()
    np.savez(path, **arrs)


def load_lora(path: str, device=None) -> Tuple[Lora, float]:
    """-> (adapter as tensors on ``device``, alpha)."""
    data = np.load(path)
    alpha = float(data["__alpha__"]) if "__alpha__" in data else 1.0
    lora: Lora = {}
    for name in data.files:
        if name == "__alpha__":
            continue
        key, part = name.rsplit("::", 1)
        lora.setdefault(key, {})[part] = torch.from_numpy(np.array(data[name])).to(device)
    return lora, alpha


# ------------------------------------------------------------- train step

def draw_t_noise(generator: torch.Generator, batch: int, shape, n_train: int):
    """Training timesteps (int64, uniform over ``[0, n_train)``) and
    standard-normal fp32 noise ``[batch, *shape]``, on the generator's
    device."""
    t = torch.randint(0, n_train, (batch,), generator=generator, dtype=torch.int64,
                      device=generator.device)
    noise = torch.randn((batch, *shape), generator=generator, dtype=torch.float32,
                        device=generator.device)
    return t, noise


def unet_apply(unet, x, t, ctx):
    """The UNet on a text context, or on SDXL's ``{"ctx", "add"}`` dict."""
    if isinstance(ctx, dict):
        return unet(x, t, ctx["ctx"], ctx["add"])
    return unet(x, t, ctx)


def denoising_loss(unet, sched: DDIMSchedule, latents: torch.Tensor, ctx, t: torch.Tensor,
                   noise: torch.Tensor) -> torch.Tensor:
    """``mean((pred - target)^2)`` in fp32 on latents already in VAE latent
    space (scaled, the ``SDDataset`` cache's layout); the target follows
    ``sched.prediction_type``."""
    x_t = add_noise(sched, latents, noise, t)
    pred = unet_apply(unet, x_t, t, ctx)
    if sched.prediction_type == "v_prediction":
        a = alphas_at(sched, t, latents.device).float()
        while a.ndim < latents.ndim:
            a = a[..., None]
        target = a.sqrt() * noise.float() - (1.0 - a).sqrt() * latents.float()
    else:
        target = noise.float()
    return torch.mean((pred.float() - target) ** 2)


def _leaves(lora: Lora) -> List[torch.Tensor]:
    return [lora[k][p] for k in sorted(lora) for p in ("a", "b")]


def lora_value_and_grad(unet, sched: DDIMSchedule, lora: Lora, latents, ctx, t, noise,
                        alpha: float = 1.0):
    """(loss, gradients as an adapter-shaped dict) at the given draws."""
    leaves = _leaves(lora)
    for x in leaves:
        x.requires_grad_(True)
    with torch.enable_grad(), apply_lora(unet, lora, alpha):
        loss = denoising_loss(unet, sched, latents, ctx, t, noise)
        grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return loss.detach(), {k: {"a": next(it), "b": next(it)} for k in sorted(lora)}


def make_optimizer(lora: Lora, lr: float = 1e-4, weight_decay: float = 1e-2):
    """optax's ``adamw(lr, weight_decay=...)``: b1 0.9, b2 0.999, eps 1e-8,
    the decoupled decay on every leaf."""
    return torch.optim.AdamW(_leaves(lora), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def make_lora_train_step(unet, sched: DDIMSchedule, optimizer: torch.optim.Optimizer,
                         alpha: float = 1.0):
    """``step(lora, latents, ctx, t, noise) -> loss``: one optimiser step
    of the adapter (in place) on the denoising loss at the given draws
    (``draw_t_noise``); ``ctx`` a text context or SDXL's dict."""

    def step(lora, latents, ctx, t, noise):
        loss, grads = lora_value_and_grad(unet, sched, lora, latents, ctx, t, noise, alpha)
        for k, pair in grads.items():
            for p, g in pair.items():
                lora[k][p].grad = g
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return loss

    return step

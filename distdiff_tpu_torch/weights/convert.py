"""Load a diffusers-layout SD-1.x, SD-2.x or SDXL checkpoint directory into
the port's modules (the port's counterpart of
``distdiff_tpu/weights/convert.py`` ``convert_sd_checkpoint`` and
``convert_sdxl_checkpoint``).

The port's UNet and VAE keep diffusers' state-dict names and its text
encoder transformers' ``CLIPTextModel`` names, so a checkpoint loads with no
key map: each component's safetensors file is read with the standard
library (``weights/safetensors.py``), held against the module's own state
dict, cast to the module's dtype and loaded with a strict
``load_state_dict``. A missing, extra or wrongly shaped key raises and names
the key; a partial load never runs with random leaves left in.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Mapping, Union

import torch

from distdiff_tpu_torch.weights.safetensors import load_file

log = logging.getLogger("distdiff.convert")

# component -> (sub-directory, the pipeline attribute holding its module)
COMPONENTS = {"unet": ("unet", "unet"), "vae": ("vae", "vae"),
              "text": ("text_encoder", "text_encoder")}
# SDXL adds the projected OpenCLIP-bigG tower
SDXL_COMPONENTS = dict(COMPONENTS, text_2=("text_encoder_2", "text_encoder_2"))
# the position-ids buffer some transformers saves carry beside the weights
POSITION_IDS = "text_model.embeddings.position_ids"


def find_weights(component_dir: str) -> str:
    """The component's weight file, by the names diffusers writes."""
    for name in ("diffusion_pytorch_model.safetensors", "model.safetensors",
                 "diffusion_pytorch_model.fp16.safetensors", "model.fp16.safetensors"):
        p = os.path.join(component_dir, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"no safetensors weights under {component_dir}")


def refuse_t5(checkpoint_dir: str) -> None:
    """The reference picks the text encoder's class from the checkpoint's
    config; a T5 encoder (the DeepFloyd-IF family) is out of scope, as in
    the JAX package, and refused loudly rather than loaded as CLIP."""
    te_cfg = os.path.join(checkpoint_dir, "text_encoder", "config.json")
    if not os.path.exists(te_cfg):
        return
    with open(te_cfg) as f:
        archs = json.load(f).get("architectures") or []
    if any("T5" in a for a in archs):
        raise NotImplementedError(
            f"checkpoint {checkpoint_dir!r} uses a T5 text encoder (DeepFloyd-IF "
            "family), which no DistDiff recipe reaches; use a CLIP-conditioned "
            "SD-1.x checkpoint")


def check_state(component: str, state: Mapping[str, torch.Tensor],
                module: torch.nn.Module) -> None:
    """Raise, naming the keys, unless ``state`` covers ``module``'s state
    dict exactly (keys and shapes)."""
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    mismatched = [f"{k} {list(state[k].shape)} (model {list(own[k].shape)})"
                  for k in own if k in state and state[k].shape != own[k].shape]
    problems = [f"{len(keys)} {label} (first: {keys[:3]})"
                for label, keys in (("missing", missing), ("extra", extra),
                                    ("shape-mismatched", mismatched)) if keys]
    if problems:
        raise ValueError(f"{component}: the checkpoint does not cover the model exactly, "
                         f"refusing to run with partial weights: " + "; ".join(problems))


def load_sd_checkpoint(checkpoint_dir: str,
                       pipe_or_modules: Union[object, Mapping[str, torch.nn.Module]],
                       strict: bool = True) -> Dict[str, int]:
    """Load ``checkpoint_dir``'s UNet, VAE and text encoder into an
    ``ExpansionPipeline`` (its ``unet``, ``vae``, ``text_encoder``) or a
    mapping with the keys ``unet``, ``vae`` and ``text``. Each tensor is
    cast to its module's dtype and device. ``strict=False`` loads the keys
    that match and skips the others. Returns the tensors loaded per
    component."""
    return _load(checkpoint_dir, pipe_or_modules, COMPONENTS, strict)


def load_sdxl_checkpoint(checkpoint_dir: str,
                         pipe_or_modules: Union[object, Mapping[str, torch.nn.Module]],
                         strict: bool = True) -> Dict[str, int]:
    """``load_sd_checkpoint`` for an SDXL directory: also ``text_encoder_2``
    (with its ``text_projection.weight``) into the pipeline's
    ``text_encoder_2`` (mapping key ``text_2``)."""
    return _load(checkpoint_dir, pipe_or_modules, SDXL_COMPONENTS, strict)


def _load(checkpoint_dir, pipe_or_modules, components, strict) -> Dict[str, int]:
    refuse_t5(checkpoint_dir)
    loaded = {}
    for comp, (sub, attr) in components.items():
        module = (pipe_or_modules[comp] if isinstance(pipe_or_modules, Mapping)
                  else getattr(pipe_or_modules, attr))
        path = find_weights(os.path.join(checkpoint_dir, sub))
        state = load_file(path)
        ids = state.pop(POSITION_IDS, None)
        if ids is not None and not torch.equal(ids.reshape(-1), torch.arange(ids.numel())):
            raise ValueError(f"{path}: {POSITION_IDS} is not 0..{ids.numel() - 1}")
        if strict:
            check_state(comp, state, module)
        else:
            own = module.state_dict()
            state = {k: v for k, v in state.items()
                     if k in own and v.shape == own[k].shape}
        module.load_state_dict(state, strict=strict)
        loaded[comp] = len(state)
        log.info("loaded %d %s tensors from %s", len(state), comp, path)
    return loaded

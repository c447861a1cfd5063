"""A diffusers-layout SD-1.x, SD-2.x or SDXL checkpoint on disk with seeded
random weights (port of ``distdiff_tpu/weights/synth.py``).

The directory holds the exact key set, shapes, dtypes and file names of a
diffusers ``runwayml/stable-diffusion-v1-5`` save, under
``linear_projection`` (SD-2.1) a ``stabilityai/stable-diffusion-2-1`` one,
or for a config with ``text_encoder_2`` a
``stabilityai/stable-diffusion-xl-base-1.0`` one (``text_encoder_2/`` and
the UNet's ``add_embedding``; ``sd15_geometry``), and a structurally valid
``tokenizer/merges.txt`` +
``vocab.json``, so the ``--sd_checkpoint`` load path runs end to end
without a real checkpoint.
The draws are the JAX writer's (``np.random.default_rng(seed)``, the same
components and keys in the same order), so both write the same arrays.
"""

from __future__ import annotations

import json
import os

import numpy as np

from distdiff_tpu_torch.models.tokenizer import _bytes_to_unicode
from distdiff_tpu_torch.weights.safetensors import save_file
from distdiff_tpu_torch.weights.sd15_geometry import (
    sd15_text_state_shapes,
    sd15_unet_state_shapes,
    sd15_vae_state_shapes,
    sdxl_text2_state_shapes,
    sdxl_unet_state_shapes,
)


def state_shapes_for_config(config):
    """The diffusers state-dict key/shape sets of a ``PipelineConfig``, by
    component (``vae``, ``text``, ``unet`` and for SDXL ``text_2``, in the
    JAX writer's order). A config with ``text_encoder_2`` takes SDXL's
    UNet layout (per-block depth, linear projections, ``add_embedding``)."""
    u, v, t, t2 = config.unet, config.vae, config.text_encoder, config.text_encoder_2
    out = {
        "vae": sd15_vae_state_shapes(chans=v.block_out_channels, layers=v.layers_per_block,
                                     lat=v.latent_channels),
        "text": sd15_text_state_shapes(d=t.hidden_size, ff=t.hidden_size * t.mlp_ratio,
                                       layers=t.num_layers, vocab=t.vocab_size,
                                       pos=t.max_length),
    }
    if t2 is not None:
        depth = u.transformer_depth
        if not isinstance(depth, (tuple, list)):
            depth = tuple(depth for _ in u.block_out_channels)
        out["unet"] = sdxl_unet_state_shapes(
            chans=u.block_out_channels, layers=u.layers_per_block, ctx=u.cross_attention_dim,
            cross_attention=u.cross_attention, transformer_depth=depth,
            addition_embed_dim=u.addition_embed_dim, in_channels=u.in_channels,
            out_channels=u.out_channels, temb_mult=u.time_embed_dim_mult)
    else:
        out["unet"] = sd15_unet_state_shapes(
            chans=u.block_out_channels, layers=u.layers_per_block, ctx=u.cross_attention_dim,
            cross_attention=u.cross_attention, in_channels=u.in_channels,
            out_channels=u.out_channels, temb_mult=u.time_embed_dim_mult,
            linear_proj=u.linear_projection)
    if t2 is not None:
        out["text_2"] = sdxl_text2_state_shapes(
            d=t2.hidden_size, ff=t2.hidden_size * t2.mlp_ratio, layers=t2.num_layers,
            vocab=t2.vocab_size, pos=t2.max_length, embed=t2.embed_dim)
    return out


def write_synth_tokenizer(checkpoint_dir: str, vocab_size: int) -> None:
    """``tokenizer/merges.txt`` + ``vocab.json`` in CLIP's layout: 256 byte
    tokens, 256 ``</w>`` byte tokens, ``vocab_size - 514`` merges, 2
    specials (49408 gives CLIP's 48894 merges)."""
    tok_dir = os.path.join(checkpoint_dir, "tokenizer")
    os.makedirs(tok_dir, exist_ok=True)
    syms = list(_bytes_to_unicode().values())
    n_merges = vocab_size - 2 * len(syms) - 2
    if not 0 < n_merges <= len(syms) ** 2:
        raise ValueError(f"vocab_size {vocab_size} leaves {n_merges} merges")
    merges = [(syms[i // len(syms)], syms[i % len(syms)]) for i in range(n_merges)]
    with open(os.path.join(tok_dir, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: synthetic\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")
    vocab = syms + [s + "</w>" for s in syms] + ["".join(m) for m in merges]
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    with open(os.path.join(tok_dir, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump({tok: i for i, tok in enumerate(vocab)}, f)


COMPONENT_FILES = {
    "unet": ("unet", "diffusion_pytorch_model.safetensors"),
    "vae": ("vae", "diffusion_pytorch_model.safetensors"),
    "text": ("text_encoder", "model.safetensors"),
    "text_2": ("text_encoder_2", "model.safetensors"),
}


def write_synth_checkpoint(checkpoint_dir: str, config=None, seed: int = 0,
                           scale: float = 0.05, dtype=np.float16,
                           tokenizer: bool = True) -> str:
    """Write the checkpoint (fp16 by default, as diffusers' fp16 variants
    ship) and return ``checkpoint_dir``. ``config`` defaults to SD-1.5."""
    if config is None:
        from distdiff_tpu_torch.config import PipelineConfig

        config = PipelineConfig.sd15()
    shapes = state_shapes_for_config(config)
    rng = np.random.default_rng(seed)
    for comp, comp_shapes in shapes.items():
        sub, fname = COMPONENT_FILES[comp]
        state = {k: (rng.standard_normal(s, np.float32) * scale).astype(dtype)
                 for k, s in comp_shapes.items()}
        save_file(state, os.path.join(checkpoint_dir, sub, fname))
    if tokenizer:
        write_synth_tokenizer(checkpoint_dir, config.text_encoder.vocab_size)
    return checkpoint_dir

"""A diffusers-layout SD-1.x or SD-2.x checkpoint on disk with seeded random
weights (port of ``distdiff_tpu/weights/synth.py``; SDXL waits for ROADMAP
queue 1 item 8).

The directory holds the exact key set, shapes, dtypes and file names of a
diffusers ``runwayml/stable-diffusion-v1-5`` save, or under
``linear_projection`` (SD-2.1) a ``stabilityai/stable-diffusion-2-1`` one
(``sd15_geometry``), and a structurally valid ``tokenizer/merges.txt`` +
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
)

SDXL_TODO = "SDXL is not ported: ROADMAP queue 1 item 8"


def state_shapes_for_config(config):
    """The diffusers state-dict key/shape sets of an SD-1.x or SD-2.x
    ``PipelineConfig``, by component (``vae``, ``text``, ``unet``, in the
    JAX writer's order)."""
    u, v, t = config.unet, config.vae, config.text_encoder
    if (getattr(config, "text_encoder_2", None) is not None
            or getattr(u, "addition_embed_dim", None) is not None):
        raise NotImplementedError(SDXL_TODO)
    return {
        "vae": sd15_vae_state_shapes(chans=v.block_out_channels, layers=v.layers_per_block,
                                     lat=v.latent_channels),
        "text": sd15_text_state_shapes(d=t.hidden_size, ff=t.hidden_size * t.mlp_ratio,
                                       layers=t.num_layers, vocab=t.vocab_size,
                                       pos=t.max_length),
        "unet": sd15_unet_state_shapes(chans=u.block_out_channels, layers=u.layers_per_block,
                                       ctx=u.cross_attention_dim,
                                       cross_attention=u.cross_attention,
                                       in_channels=u.in_channels, out_channels=u.out_channels,
                                       temb_mult=u.time_embed_dim_mult,
                                       linear_proj=u.linear_projection),
    }


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

"""OpenCLIP ViT-B/32 checkpoints -> the port's ``CLIPViT`` (image tower) and
``CLIPTextEncoder`` (text tower) state dicts (port of
``distdiff_tpu/weights/openclip.py``).

The reference's default guide is ``open_clip_vit_b32`` with pretrained
towers. This converter takes the OpenCLIP/OpenAI-CLIP state dict
(``visual.*`` image tower; ``transformer.*``, ``token_embedding``,
``positional_embedding``, ``ln_final``, ``text_projection`` text tower; the
joint ``logit_scale``) and emits the port's names directly: the image tower
``models/guide/clip_vit.py``'s, the text tower transformers'
``CLIPTextModel`` names of ``models/text_encoder.py`` (B/32 geometry: width
512, 12 layers, 8 heads, embed 512). The fused ``attn.in_proj_weight``
[3d, d] splits into ``q_proj``/``k_proj``/``v_proj`` ([d, d] each, already
torch's [out, in]); ``text_projection`` [width, embed] becomes the
bias-free Linear's weight, transposed. ``openclip_vit_b32_state_shapes``
enumerates the published layout (151,277,313 values with ``logit_scale``).
"""

from __future__ import annotations

import logging
import math
import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

Shape = Tuple[int, ...]

CLIP_VIT_B32_TOTAL = 151_277_313


# ----------------------------------------------------------- enumeration

def _tower_shapes(prefix: str, width: int, layers: int, out: Dict[str, Shape]) -> None:
    for i in range(layers):
        p = f"{prefix}.resblocks.{i}"
        out[f"{p}.ln_1.weight"] = (width,)
        out[f"{p}.ln_1.bias"] = (width,)
        out[f"{p}.attn.in_proj_weight"] = (3 * width, width)
        out[f"{p}.attn.in_proj_bias"] = (3 * width,)
        out[f"{p}.attn.out_proj.weight"] = (width, width)
        out[f"{p}.attn.out_proj.bias"] = (width,)
        out[f"{p}.ln_2.weight"] = (width,)
        out[f"{p}.ln_2.bias"] = (width,)
        out[f"{p}.mlp.c_fc.weight"] = (4 * width, width)
        out[f"{p}.mlp.c_fc.bias"] = (4 * width,)
        out[f"{p}.mlp.c_proj.weight"] = (width, 4 * width)
        out[f"{p}.mlp.c_proj.bias"] = (width,)


def openclip_vit_b32_state_shapes(
    image_size: int = 224, patch: int = 32, vw: int = 768, vlayers: int = 12,
    tw: int = 512, tlayers: int = 12, embed: int = 512,
    vocab: int = 49408, ctx_len: int = 77,
) -> Dict[str, Shape]:
    """Every key of an OpenCLIP ViT-B/32 state dict and its shape (the
    arguments shrink it for tests)."""
    grid = image_size // patch
    out: Dict[str, Shape] = {
        "logit_scale": (),
        "visual.conv1.weight": (vw, 3, patch, patch),
        "visual.class_embedding": (vw,),
        "visual.positional_embedding": (grid * grid + 1, vw),
        "visual.ln_pre.weight": (vw,),
        "visual.ln_pre.bias": (vw,),
        "visual.ln_post.weight": (vw,),
        "visual.ln_post.bias": (vw,),
        "visual.proj": (vw, embed),
        "token_embedding.weight": (vocab, tw),
        "positional_embedding": (ctx_len, tw),
        "ln_final.weight": (tw,),
        "ln_final.bias": (tw,),
        "text_projection": (tw, embed),
    }
    _tower_shapes("visual.transformer", vw, vlayers, out)
    _tower_shapes("transformer", tw, tlayers, out)
    return out


def state_size(shapes: Mapping[str, Shape]) -> int:
    return sum(math.prod(s) for s in shapes.values())


# ------------------------------------------------------------ conversion

# OpenCLIP's names inside a residual block -> (image tower's, text tower's)
_BLOCK_NAMES = {
    "ln_1": ("ln_1", "layer_norm1"),
    "ln_2": ("ln_2", "layer_norm2"),
    "attn.out_proj": ("out_proj", "self_attn.out_proj"),
    "mlp.c_fc": ("c_fc", "mlp.fc1"),
    "mlp.c_proj": ("c_proj", "mlp.fc2"),
}
_QKV = (("q_proj", "self_attn.q_proj"), ("k_proj", "self_attn.k_proj"),
        ("v_proj", "self_attn.v_proj"))
_TEXT = "text_model."


def _convert_block(out: Dict[str, torch.Tensor], base: str, tower: int, rest: str,
                   t: torch.Tensor) -> bool:
    """One ``resblocks.N.<rest>`` tensor into ``out`` under ``base``
    (``tower`` 0 image, 1 text); True if taken."""
    if rest in ("attn.in_proj_weight", "attn.in_proj_bias"):
        leaf = "weight" if rest.endswith("weight") else "bias"
        for j, q in enumerate(t.chunk(3, dim=0)):
            out[f"{base}{_QKV[j][tower]}.{leaf}"] = q
        return True
    name, _, leaf = rest.rpartition(".")
    if name not in _BLOCK_NAMES or leaf not in ("weight", "bias"):
        return False
    out[f"{base}{_BLOCK_NAMES[name][tower]}.{leaf}"] = t
    return True


def _as_tensor(v) -> torch.Tensor:
    return v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))


def convert_openclip(state: Mapping[str, object]
                     ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], Optional[float]]:
    """(image state dict, text state dict, logit_scale) from an OpenCLIP
    state dict (torch tensors or numpy arrays). ``logit_scale`` is the
    exponential of the stored value, None where the state has none. The
    causal mask and position-id buffers are skipped; any other key the map
    lacks is logged."""
    visual: Dict[str, torch.Tensor] = {}
    text: Dict[str, torch.Tensor] = {}
    logit_scale: Optional[float] = None
    unused = []
    for key, value in state.items():
        t = _as_tensor(value)
        m = re.match(r"^(visual\.)?transformer\.resblocks\.(\d+)\.(.+)$", key)
        if key == "logit_scale":
            logit_scale = float(np.exp(t.float().numpy()))
        elif key == "visual.conv1.weight":
            visual["patch_embed.weight"] = t
        elif key in ("visual.class_embedding", "visual.positional_embedding", "visual.proj"):
            visual[key[len("visual."):]] = t
        elif re.match(r"^visual\.ln_(pre|post)\.(weight|bias)$", key):
            visual[key[len("visual."):]] = t
        elif m:
            if m.group(1):
                ok = _convert_block(visual, f"resblocks.{m.group(2)}.", 0, m.group(3), t)
            else:
                ok = _convert_block(text, f"{_TEXT}encoder.layers.{m.group(2)}.", 1,
                                    m.group(3), t)
            if not ok:
                unused.append(key)
        elif key == "token_embedding.weight":
            text[f"{_TEXT}embeddings.token_embedding.weight"] = t
        elif key == "positional_embedding":
            text[f"{_TEXT}embeddings.position_embedding.weight"] = t
        elif key in ("ln_final.weight", "ln_final.bias"):
            text[f"{_TEXT}final_layer_norm.{key.split('.')[1]}"] = t
        elif key == "text_projection":
            text["text_projection.weight"] = t.T.contiguous()  # pooled @ proj
        elif "attn_mask" in key or key.endswith("position_ids"):
            continue  # constant buffers
        else:
            unused.append(key)
    if unused:
        logging.getLogger("distdiff.convert").warning(
            "openclip: %d unconverted keys (first: %s)", len(unused), unused[:3])
    return visual, text, logit_scale


def load_openclip_checkpoint(path: str):
    """Read an OpenCLIP checkpoint (``.safetensors`` through the port's own
    reader; ``.pt``/``.pth``/``.bin`` through ``torch.load``, its
    ``state_dict`` entry where it has one, a ``module.`` prefix stripped)
    and convert it: (image state dict, text state dict, logit_scale)."""
    from distdiff_tpu_torch.models.guide.factory import read_state_dict

    return convert_openclip({(k[len("module."):] if k.startswith("module.") else k): v
                             for k, v in read_state_dict(path).items()})

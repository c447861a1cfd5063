"""JAX parameter trees -> state dicts of the port's modules.

Walks the port's own ``state_dict()`` keys (diffusers' names for the UNet and
VAE, transformers' for the CLIP text encoder, torchvision's for the guide
CNNs, the JAX tree's for the guide CLIP ViT), maps each to its path in the
JAX tree with copies of the reference's key maps (``weights/convert.py``
``map_unet_key``/``map_vae_key``/``map_text_key``,
``models/guide/factory.py`` ``_torch_key_to_ours`` and
``_mobilenet_torch_key``), and
undoes the reference's layout transform
(``convert.py:transform_tensor``): HWIO -> OIHW, ``[in, out]`` -> ``[out, in]``,
a channel ``Dense`` -> ``[O, I, 1, 1]`` where diffusers stores a 1x1 conv, and
BatchNorm ``mean``/``var`` -> ``running_mean``/``running_var``.

Strict: a key with no JAX counterpart, a JAX leaf left unused, or a shape
that differs raises. The port keeps its own copy of the key maps; it imports
nothing of the JAX package.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from distdiff_tpu_torch.config import TextEncoderConfig, UNetConfig, VAEConfig
from distdiff_tpu_torch.models.guide.clip_vit import CLIPViT, CLIPViTConfig
from distdiff_tpu_torch.models.guide.mobilenet import MobileNetV2, MobileNetV2Config
from distdiff_tpu_torch.models.guide.resnet import ResNet, ResNetConfig

Config = Union[UNetConfig, VAEConfig, TextEncoderConfig, ResNetConfig, MobileNetV2Config,
               CLIPViTConfig]
_GUIDES = {ResNetConfig: ResNet, MobileNetV2Config: MobileNetV2, CLIPViTConfig: CLIPViT}


# ------------------------------------------------ key maps (reference copies)

def map_unet_key(key: str) -> Optional[str]:
    """diffusers UNet2DConditionModel name -> the JAX UNet2DCondition path."""
    k = key
    k = re.sub(r"^time_embedding\.linear_(\d)\.", r"time_embedding/linear_\1/", k)
    k = re.sub(r"^add_embedding\.linear_(\d)\.", r"add_embedding/linear_\1/", k)
    k = re.sub(r"^conv_in\.", "conv_in/", k)
    k = re.sub(r"^conv_norm_out\.", "conv_norm_out/", k)
    k = re.sub(r"^conv_out\.", "conv_out/", k)
    k = re.sub(r"^down_blocks\.(\d+)\.resnets\.(\d+)\.", r"down_\1_res_\2/", k)
    k = re.sub(r"^down_blocks\.(\d+)\.attentions\.(\d+)\.", r"down_\1_attn_\2/", k)
    k = re.sub(r"^down_blocks\.(\d+)\.downsamplers\.0\.conv\.", r"down_\1_downsample/conv/", k)
    k = re.sub(r"^up_blocks\.(\d+)\.resnets\.(\d+)\.", r"up_\1_res_\2/", k)
    k = re.sub(r"^up_blocks\.(\d+)\.attentions\.(\d+)\.", r"up_\1_attn_\2/", k)
    k = re.sub(r"^up_blocks\.(\d+)\.upsamplers\.0\.conv\.", r"up_\1_upsample/conv/", k)
    k = re.sub(r"^mid_block\.resnets\.(\d+)\.", r"mid_res_\1/", k)
    k = re.sub(r"^mid_block\.attentions\.0\.", "mid_attn/", k)
    k = re.sub(r"transformer_blocks\.(\d+)\.", r"transformer_blocks_\1/", k)
    k = k.replace("attn1.", "attn1/").replace("attn2.", "attn2/")
    k = k.replace("to_out.0.", "to_out/")
    k = k.replace("ff.net.0.proj.", "ff/net_0/proj/")
    k = k.replace("ff.net.2.", "ff/net_2/")
    k = k.replace("proj_in.", "proj_in/").replace("proj_out.", "proj_out/")
    k = re.sub(r"norm(\d)\.", r"norm\1/", k)
    k = k.replace("norm.", "norm/")
    k = k.replace("time_emb_proj.", "time_emb_proj/")
    k = k.replace("conv_shortcut.", "conv_shortcut/")
    k = re.sub(r"conv(\d)\.", r"conv\1/", k)
    k = k.replace("to_q.", "to_q/").replace("to_k.", "to_k/").replace("to_v.", "to_v/")
    return None if "." in k else k


def map_vae_key(key: str) -> Optional[str]:
    """diffusers AutoencoderKL name -> the JAX AutoencoderKL path."""
    k = key
    k = re.sub(r"^quant_conv\.", "quant_conv/", k)
    k = re.sub(r"^post_quant_conv\.", "post_quant_conv/", k)
    for side in ("encoder", "decoder"):
        k = re.sub(rf"^{side}\.conv_in\.", f"{side}/conv_in/", k)
        k = re.sub(rf"^{side}\.conv_norm_out\.", f"{side}/conv_norm_out/", k)
        k = re.sub(rf"^{side}\.conv_out\.", f"{side}/conv_out/", k)
        k = re.sub(rf"^{side}\.mid_block\.resnets\.(\d+)\.", rf"{side}/mid_res_\1/", k)
        k = re.sub(rf"^{side}\.mid_block\.attentions\.0\.", f"{side}/mid_attn/", k)
    k = re.sub(r"^encoder\.down_blocks\.(\d+)\.resnets\.(\d+)\.", r"encoder/down_\1_res_\2/", k)
    k = re.sub(r"^encoder\.down_blocks\.(\d+)\.downsamplers\.0\.conv\.",
               r"encoder/down_\1_downsample/conv/", k)
    k = re.sub(r"^decoder\.up_blocks\.(\d+)\.resnets\.(\d+)\.", r"decoder/up_\1_res_\2/", k)
    k = re.sub(r"^decoder\.up_blocks\.(\d+)\.upsamplers\.0\.conv\.",
               r"decoder/up_\1_upsample/conv/", k)
    k = k.replace("group_norm.", "group_norm/")
    k = k.replace("to_out.0.", "to_out/")
    k = k.replace("to_q.", "to_q/").replace("to_k.", "to_k/").replace("to_v.", "to_v/")
    k = re.sub(r"norm(\d)\.", r"norm\1/", k)
    k = k.replace("conv_shortcut.", "conv_shortcut/")
    k = re.sub(r"conv(\d)\.", r"conv\1/", k)
    return None if "." in k else k


def map_text_key(key: str) -> Optional[str]:
    """transformers CLIPTextModel name -> the JAX CLIPTextEncoder path."""
    k = key.replace("text_model.", "")
    if k == "embeddings.token_embedding.weight":
        return "token_embedding/embedding"
    if k == "embeddings.position_embedding.weight":
        return "position_embedding"
    if k == "text_projection.weight":  # a bare [hidden, embed] parameter in JAX
        return "text_projection"
    k = re.sub(r"^encoder\.layers\.(\d+)\.", r"layers_\1/", k)
    k = k.replace("self_attn.", "").replace("mlp.", "")
    k = re.sub(r"(q_proj|k_proj|v_proj|out_proj|fc1|fc2)\.", r"\1/", k)
    k = re.sub(r"layer_norm(\d)\.", r"layer_norm\1/", k)
    k = k.replace("final_layer_norm.", "final_layer_norm/")
    return None if "." in k else k


def map_guide_key(key: str) -> Optional[str]:
    """A guide's state-dict name (torchvision's ResNet and MobileNetV2
    names, the CLIP ViT's) -> its JAX path (``/``-joined, leaf still
    torch's)."""
    parts = key.split(".")
    if parts[0] == "features":  # torchvision mobilenet_v2
        return _mobilenet_key(parts)
    if parts[0] == "classifier" and len(parts) == 3:
        return f"classifier/{parts[2]}"  # classifier.1 (index 0 is Dropout)
    if parts[0] == "resblocks":  # the CLIP ViT's blocks
        return f"resblocks_{parts[1]}/{'/'.join(parts[2:])}"
    if parts[0].startswith("layer") and len(parts) >= 3:
        block = f"{parts[0]}_{parts[1]}"
        rest = parts[2:]
        if rest[0] == "downsample":
            sub = "downsample_conv" if rest[1] == "0" else "downsample_bn"
            return f"{block}/{sub}/{rest[2]}"
        return f"{block}/{'/'.join(rest)}"
    return "/".join(parts)


def _mobilenet_key(parts) -> str:
    """torchvision ``features.*`` -> the JAX MobileNetV2 names: features.0
    the stem, features.1..17 the inverted residuals (features.1 has no
    expand conv), features.18 the head."""
    fi, leaf = int(parts[1]), parts[-1]
    if fi == 0:
        return f"{'stem_conv' if parts[2] == '0' else 'stem_bn'}/{leaf}"
    if fi == 18:
        return f"{'head_conv' if parts[2] == '0' else 'head_bn'}/{leaf}"
    if fi == 1:  # expand 1: conv.0.0 dw, conv.0.1 dw_bn, conv.1, conv.2
        table = {("0", "0"): "dw_conv", ("0", "1"): "dw_bn",
                 ("1",): "project_conv", ("2",): "project_bn"}
    else:
        table = {("0", "0"): "expand_conv", ("0", "1"): "expand_bn",
                 ("1", "0"): "dw_conv", ("1", "1"): "dw_bn",
                 ("2",): "project_conv", ("3",): "project_bn"}
    return f"block_{fi - 1}/{table[tuple(parts[3:-1])]}/{leaf}"


# ------------------------------------------------------- layout transforms

def _identity(a: np.ndarray) -> np.ndarray:
    return a


def _from_hwio(a: np.ndarray) -> np.ndarray:
    return a.transpose(3, 2, 0, 1)


def _from_dense(a: np.ndarray) -> np.ndarray:
    return a.T


def _from_dense_1x1(a: np.ndarray) -> np.ndarray:
    return a.T[:, :, None, None]


Entry = Tuple[Optional[str], Tuple[int, ...], Callable[[np.ndarray], np.ndarray]]


def _weight_entry(path: str, shape: Tuple[int, ...]) -> Entry:
    """(JAX path, JAX shape, inverse transform) of a ``weight`` leaf."""
    parts = path.split("/")
    base, parent = parts[:-1], (parts[-2] if len(parts) > 1 else "")
    if len(shape) == 4:
        if parent in ("proj_in", "proj_out", "conv_shortcut") and shape[2:] == (1, 1):
            return "/".join(base + ["kernel"]), (shape[1], shape[0]), _from_dense_1x1
        return ("/".join(base + ["kernel"]), (shape[2], shape[3], shape[1], shape[0]),
                _from_hwio)
    if len(shape) == 2:
        return "/".join(base + ["kernel"]), (shape[1], shape[0]), _from_dense
    return "/".join(base + ["scale"]), shape, _identity


def _entry(kind: str, key: str, shape: Tuple[int, ...]) -> Entry:
    if kind == "guide":
        mapped = map_guide_key(key)
        base, leaf = mapped.rsplit("/", 1) if "/" in mapped else ("", mapped)
        prefix = f"{base}/" if base else ""
        if leaf == "running_mean":
            return f"batch_stats/{prefix}mean", shape, _identity
        if leaf == "running_var":
            return f"batch_stats/{prefix}var", shape, _identity
        if leaf == "weight":
            path, jshape, inv = _weight_entry(mapped, shape)
            return f"params/{path}", jshape, inv
        return f"params/{mapped}", shape, _identity
    mapped = {"unet": map_unet_key, "vae": map_vae_key, "text": map_text_key}[kind](key)
    if mapped is None:
        return None, shape, _identity
    if mapped == "text_projection":
        return mapped, (shape[1], shape[0]), _from_dense
    if mapped.endswith("/weight"):
        return _weight_entry(mapped, shape)
    return mapped, shape, _identity


def jax_leaf(kind: str, key: str, shape: Tuple[int, ...]) -> Tuple[Optional[str], Tuple[int, ...]]:
    """(JAX path, JAX shape) of the port's state-dict ``key`` of ``shape``
    in a model of ``kind`` ("unet", "vae" or "text")."""
    path, jshape, _ = _entry(kind, key, tuple(shape))
    return path, jshape


def _port_model(config: Config):
    from distdiff_tpu_torch.models.text_encoder import CLIPTextEncoder
    from distdiff_tpu_torch.models.unet import UNet2DConditionModel
    from distdiff_tpu_torch.models.vae import AutoencoderKL

    if isinstance(config, TextEncoderConfig):
        return "text", CLIPTextEncoder(config, device="meta")
    if isinstance(config, UNetConfig):
        return "unet", UNet2DConditionModel(config, device="meta")
    if isinstance(config, VAEConfig):
        return "vae", AutoencoderKL(config, device="meta")
    if type(config) in _GUIDES:
        return "guide", _GUIDES[type(config)](config, device="meta")
    raise TypeError(f"no port model for {type(config).__name__}")


# BatchNorm's update counter has no JAX counterpart (the guide runs in eval
# mode); it is set to 0.
_COUNTER = "num_batches_tracked"


def key_table(config: Config) -> Dict[str, Entry]:
    """port state-dict key -> (JAX path, JAX shape, inverse transform),
    from the port's module built on the meta device."""
    kind, model = _port_model(config)
    return _module_table(kind, model)


def _module_table(kind: str, module: torch.nn.Module, prefix: str = "") -> Dict[str, Entry]:
    """The key table of ``module`` as it sits at ``prefix`` in a model of
    ``kind``; with a prefix, the leading component of each JAX path (the
    prefix's own) is dropped."""
    table = {}
    for k, v in module.state_dict().items():
        if k.endswith(_COUNTER):
            continue
        path, shape, inverse = _entry(kind, prefix + k, tuple(v.shape))
        if prefix and path is not None:
            path = path.split("/", 1)[1]
        table[k] = (path, shape, inverse)
    return table


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _convert(params_np: Dict[str, Any], table: Dict[str, Entry]) -> Dict[str, torch.Tensor]:
    flat = _flatten(params_np)
    out: Dict[str, torch.Tensor] = {}
    used = set()
    for key, (path, shape, inverse) in table.items():
        if path is None:
            raise KeyError(f"{key}: no JAX counterpart in the key map")
        if path not in flat:
            raise KeyError(f"{key}: JAX leaf {path!r} is missing")
        arr = np.asarray(flat[path], dtype=np.float32)
        if arr.shape != shape:
            raise ValueError(f"{key}: JAX leaf {path!r} has shape {arr.shape}, "
                             f"expected {shape}")
        out[key] = torch.from_numpy(np.array(inverse(arr), copy=True))
        used.add(path)
    extra = sorted(set(flat) - used)
    if extra:
        raise KeyError(f"{len(extra)} JAX leaves left unused (first: {extra[:3]})")
    return out


def state_dict_from_jax(params_np: Dict[str, Any], config: Config) -> Dict[str, torch.Tensor]:
    """A strict state dict for the port's module of ``config`` from the JAX
    parameter tree (numpy leaves). For a guide config, pass the JAX
    variables (``{"params": ..., "batch_stats": ...}``; the CLIP ViT has
    ``params`` only)."""
    kind, model = _port_model(config)
    out = _convert(params_np, _module_table(kind, model))
    for k in model.state_dict():
        if k.endswith(_COUNTER):
            out[k] = torch.zeros((), dtype=torch.long)
    return out


def submodule_state_dict_from_jax(params_np: Dict[str, Any], module: torch.nn.Module,
                                  kind: str, prefix: str) -> Dict[str, torch.Tensor]:
    """The same for one block of a ``kind`` ("unet" or "vae") model, given
    the diffusers prefix it sits at (e.g. ``"down_blocks.0.resnets.0."``)
    and the block's own JAX parameter tree."""
    return _convert(params_np, _module_table(kind, module, prefix))


# ------------------------------------------------------- trainer state

def _named_tuples(tree: Any, field: str):
    """The NamedTuple nodes of ``tree`` (an optax state, leaves as numpy)
    that have ``field``, depth first."""
    if hasattr(tree, "_fields"):
        if field in tree._fields:
            yield tree
        children = tuple(tree)
    elif isinstance(tree, (tuple, list)):
        children = tree
    elif isinstance(tree, dict):
        children = tuple(tree.values())
    else:
        return
    for child in children:
        yield from _named_tuples(child, field)


def _one(tree: Any, field: str, what: str):
    found = list(_named_tuples(tree, field))
    if len(found) != 1:
        raise ValueError(f"the optax state has {len(found)} {what}s, expected 1")
    return getattr(found[0], field)


@torch.no_grad()
def load_jax_train_state(state, jax_state) -> None:
    """Carry a JAX ``TrainState`` (``distdiff_tpu/train/classifier.py``, its
    leaves as numpy) into the port's ``TrainState`` (module and optimiser,
    in place), so that a run can be split between the two packages.

    ``params`` and ``batch_stats`` become the module's state dict (the
    update counters ``num_batches_tracked`` 0). In the optax state,
    ``sgd``'s trace becomes SGD's ``momentum_buffer`` of each parameter the
    optimiser trains (a leaf masked out by ``train_fc`` has none), the
    schedule's count the optimiser's ``count``, and a ``MultiSteps``
    state's ``mini_step`` and ``acc_grads`` its accumulation."""
    module, tx = state.module, state.tx
    cfg = module.cfg
    device = next(module.parameters()).device
    variables = {"params": jax_state.params, "batch_stats": jax_state.batch_stats}
    sd = state_dict_from_jax(variables, cfg)
    module.load_state_dict({k: v.to(device) for k, v in sd.items()})

    table = key_table(cfg)
    by_param = {id(p): name for name, p in module.named_parameters()}

    def per_param(tree) -> list:
        """A params-shaped optax tree -> one tensor a trained parameter."""
        flat = _flatten({"params": tree})
        out = []
        for p in tx.params:
            path, shape, inverse = table[by_param[id(p)]]
            arr = np.asarray(flat[path], np.float32)
            if arr.shape != shape:
                raise ValueError(f"optax leaf {path!r} has shape {arr.shape}, expected {shape}")
            out.append(torch.from_numpy(np.array(inverse(arr), copy=True)).to(device))
        return out

    opt = jax_state.opt_state
    multi = list(_named_tuples(opt, "mini_step"))
    if multi:
        ms = multi[0]
        tx.mini_step = int(ms.mini_step)
        tx.acc = per_param(ms.acc_grads) if tx.mini_step else None
        opt = ms.inner_opt_state
    for p, buf in zip(tx.params, per_param(_one(opt, "trace", "trace"))):
        tx.sgd.state[p]["momentum_buffer"] = buf
    tx.count = int(_one(opt, "count", "schedule count"))

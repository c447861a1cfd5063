"""Guide-model factory (port of ``distdiff_tpu/models/guide/factory.py``):
``GuideModel``, ``create_model`` for the JAX package's six archs
(``resnet50``, ``resnext50``, ``mobilenetv2``, ``wideresnet50``,
``open_clip_vit_b32`` and the test miniature ``tiny_resnet``),
``build_zero_shot_text_features`` and ``load_weights``.

The CNNs keep torchvision's state-dict names, so a reference
``checkpoint.pth.tar`` (after stripping a ``module.`` prefix) or a
torchvision checkpoint loads key for key. OpenCLIP checkpoints (keys under
``visual.*``) are converted by ``weights/openclip.py`` into the image tower
and the text tower's weights, from which the zero-shot head is built.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from distdiff_tpu_torch.config import TextEncoderConfig
from distdiff_tpu_torch.device import resolve_device
from distdiff_tpu_torch.models.guide.clip_vit import CLIPViT, CLIPViTConfig, zero_shot_logits
from distdiff_tpu_torch.models.guide.mobilenet import MobileNetV2, MobileNetV2Config
from distdiff_tpu_torch.models.guide.resnet import (
    ResNet,
    resnet50_config,
    resnext50_config,
    tiny_resnet_config,
    wideresnet50_config,
)
from distdiff_tpu_torch.models.init import init_weights
from distdiff_tpu_torch.models.text_encoder import CLIPTextEncoder
from distdiff_tpu_torch.models.tokenizer import load_tokenizer

ARCHS = (
    "resnet50",
    "resnext50",
    "mobilenetv2",
    "wideresnet50",
    "open_clip_vit_b32",
    "tiny_resnet",   # test-only miniature (not in the reference)
)
_RESNETS = {"resnet50": resnet50_config, "resnext50": resnext50_config,
            "wideresnet50": wideresnet50_config, "tiny_resnet": tiny_resnet_config}

log = logging.getLogger("distdiff.guide")


@dataclasses.dataclass
class GuideModel:
    """A guide classifier and the calls DistDiff needs: ``encode_image``
    (features for the prototypes and the energy) and ``logits``."""

    arch: str
    module: torch.nn.Module
    feature_dim: int
    num_classes: int
    # open_clip_vit_b32's zero-shot head: [num_classes, embed_dim] text features
    class_text_features: Optional[torch.Tensor] = None
    # the text tower's weights (CLIPTextEncoder names), set when an OpenCLIP
    # checkpoint was loaded; build_zero_shot_text_features builds the
    # tower from them
    text_state: Optional[Dict[str, torch.Tensor]] = None
    logit_scale: Optional[float] = None
    # the text tower's MLP activation: laion2b towers (the reference's
    # default checkpoint) use gelu, OpenAI CLIP releases quick_gelu;
    # detected at load time (_load_openclip_into)
    text_activation: str = "gelu"

    def encode_image(self, x: torch.Tensor, pooling: str = "avg") -> torch.Tensor:
        return self.module.encode_image(x, pooling)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        out = self.module(x)
        if self.arch == "open_clip_vit_b32":
            if self.class_text_features is None:
                raise ValueError("open_clip_vit_b32 needs class_text_features (zero-shot head)")
            out = zero_shot_logits(out, self.class_text_features)
        return out


def _build_module(arch: str, num_classes: int, device):
    """(module, feature_dim) of ``arch``."""
    if arch in _RESNETS:
        cfg = _RESNETS[arch](num_classes)
        return ResNet(cfg, device=device), cfg.feature_dim
    if arch == "mobilenetv2":
        cfg = MobileNetV2Config(num_classes=num_classes)
        return MobileNetV2(cfg, device=device), cfg.feature_dim
    if arch == "open_clip_vit_b32":
        cfg = CLIPViTConfig()
        return CLIPViT(cfg, device=device), cfg.embed_dim
    raise ValueError(f"unknown arch {arch!r}; expected one of {ARCHS}")


def create_model(arch: str, num_classes: int, weight_path: Optional[str] = None,
                 input_size: int = 224,
                 device: Union[str, torch.device] = "cuda", pretrained: bool = False,
                 trainable: bool = False, class_names: Optional[Sequence[str]] = None,
                 class_text_features=None, bpe_path: Optional[str] = None,
                 tokenizer_checkpoint_dir: Optional[str] = None) -> GuideModel:
    """Build a guide and load ``weight_path`` into it (``load_weights``).

    The guide is frozen, in eval mode, with the weights as the module
    initialises them. ``trainable`` builds the trainer's classifier
    instead: in training mode, gradients on, its weights drawn as flax
    draws them (``init_weights``: lecun-normal kernels, zero biases, unit
    norm scales, the CLIP ViT's raw parameters normal(0.02)) before
    ``weight_path`` is loaded. ``pretrained`` without a ``weight_path``
    changes nothing, as in the JAX factory (ImageNet weights come only from
    a file). ``input_size`` is the JAX factory's init size; the modules
    take their input size from the images, so it is unused (the CLIP ViT's
    is 224, fixed by its positional embedding).

    ``open_clip_vit_b32``'s zero-shot head: ``class_text_features`` as
    given, or, when an OpenCLIP checkpoint brought a text tower and
    ``class_names`` are given, encoded from "a photo of a {}." by that
    tower (``build_zero_shot_text_features``; real text weights demand a
    real merges file, ``bpe_path`` or ``tokenizer_checkpoint_dir``)."""
    del input_size, pretrained
    device = resolve_device(device)
    if trainable:
        module, feature_dim = _build_module(arch, num_classes, "cpu")
        init_weights(module, torch.Generator().manual_seed(0))
        module.to(device).train()
    else:
        module, feature_dim = _build_module(arch, num_classes, device)
        module.requires_grad_(False)
    gm = GuideModel(arch=arch, module=module, feature_dim=feature_dim, num_classes=num_classes)
    if class_text_features is not None:
        gm.class_text_features = torch.as_tensor(np.asarray(class_text_features, np.float32),
                                                 device=device)
    if weight_path:
        load_weights(gm, weight_path)
    if (arch == "open_clip_vit_b32" and gm.class_text_features is None
            and class_names is not None and gm.text_state is not None):
        gm.class_text_features = torch.as_tensor(build_zero_shot_text_features(
            class_names, state=gm.text_state, bpe_path=bpe_path,
            checkpoint_dir=tokenizer_checkpoint_dir, activation=gm.text_activation,
            device=device), device=device)
    return gm


def zero_shot_text_config(activation: str = "gelu") -> TextEncoderConfig:
    """The CLIP ViT-B/32 text tower's geometry, in fp32."""
    return TextEncoderConfig(hidden_size=512, num_layers=12, num_heads=8, embed_dim=512,
                             activation=activation, dtype=torch.float32)


@torch.no_grad()
def build_zero_shot_text_features(
    classnames: Sequence[str],
    template: str = "a photo of a {}.",
    bpe_path: Optional[str] = None,
    config: Optional[TextEncoderConfig] = None,
    state: Optional[Dict[str, torch.Tensor]] = None,
    activation: str = "gelu",
    checkpoint_dir: Optional[str] = None,
    strict: Optional[bool] = None,
    device: Union[str, torch.device] = "cuda",
) -> np.ndarray:
    """Class-template prompts encoded into the CLIP contrastive space
    ``[C, embed_dim]`` (fp32 numpy): the zero-shot head of the reference's
    ``wrap_clip_forward``, through ``CLIPTextEncoder.encode_pooled``.

    ``state``: the converted OpenCLIP text tower (``GuideModel.text_state``),
    loaded strictly into a tower of ``config`` (default: the B/32 geometry
    with ``activation``, ``GuideModel.text_activation``). Without it the
    tower keeps seeded flax-style random weights: a mechanically correct
    head for tests and smoke runs only. ``strict`` defaults to "a real tower
    was given": real weights with hash-tokenizer ids would give wrong
    features quietly, so the tokenizer lookup then raises unless a merges
    file is found (``bpe_path``, ``$DISTDIFF_CLIP_BPE`` or
    ``checkpoint_dir/tokenizer/merges.txt``)."""
    device = resolve_device(device)
    if strict is None:
        strict = state is not None
    if state is not None:
        log.info("zero-shot head: encoding %d class prompts with a real text tower "
                 "(activation=%s)", len(classnames), activation)
    config = zero_shot_text_config(activation) if config is None else config
    tok = load_tokenizer(bpe_path, max_length=config.max_length,
                         vocab_size=config.vocab_size, checkpoint_dir=checkpoint_dir,
                         strict=strict)
    ids = torch.as_tensor(tok([template.format(c) for c in classnames]), device=device).long()
    if state is None:
        te = CLIPTextEncoder(config, device="cpu")
        init_weights(te, torch.Generator().manual_seed(0))
        te.to(device)
    else:
        te = CLIPTextEncoder(config, device=device)
        te.load_state_dict(state)
    te.eval()
    return te.encode_pooled(ids).float().cpu().numpy()


# ------------------------------------------------------------- checkpoints

def load_weights(gm: GuideModel, path: str) -> None:
    """Load guide weights from a torch ``checkpoint.pth.tar`` (the
    reference's format) or a torchvision state dict, a ``.safetensors``
    file of the same, a numpy ``.npz`` of the JAX package's flat variable
    tree (``params/...``, ``batch_stats/...``), or an OpenCLIP checkpoint
    (keys under ``visual.*``, unprefixed, as the JAX loader takes them;
    ``.safetensors``, ``.pt``, ``.pth``, ``.bin``), which sets both towers."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory (an orbax checkpoint of the JAX package); the port "
            "reads .pth.tar, .safetensors and .npz guide weights: save the variables "
            "as a flat .npz of the JAX tree")
    if path.endswith(".npz"):
        _load_jax_npz(gm, path)
        return
    state = read_state_dict(path)
    if any(k.startswith("visual.") for k in state):
        _load_openclip_into(gm, state)
    else:
        _load_torch_state_dict(gm, state, path)


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint file's state dict: ``.safetensors`` through the port's
    stdlib reader, anything else through ``torch.load`` (its
    ``state_dict`` entry where it has one)."""
    if path.endswith(".safetensors"):
        from distdiff_tpu_torch.weights.safetensors import load_file

        return load_file(path)
    state = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return state


# scalar buffers of OpenAI CLIP releases that open_clip's laion checkpoints
# lack: open_clip's own rule for picking quick_gelu
_OPENAI_MARKERS = {"input_resolution", "context_length", "vocab_size"}


@torch.no_grad()
def _load_openclip_into(gm: GuideModel, state) -> None:
    """Both towers of an OpenCLIP state dict (the JAX loader's rules): the
    image tower strictly into ``gm.module`` (a missing, extra or mis-shaped
    key raises), the text tower's weights into ``gm.text_state``, the
    activation from the OpenAI markers (quick_gelu with, gelu without)."""
    from distdiff_tpu_torch.weights.openclip import convert_openclip

    is_openai = bool(_OPENAI_MARKERS & set(state))
    state = {(k[len("module."):] if k.startswith("module.") else k): v
             for k, v in state.items() if k.split("module.")[-1] not in _OPENAI_MARKERS}
    visual, text, logit_scale = convert_openclip(state)
    own = gm.module.state_dict()
    missing = sorted(set(own) - set(visual))
    extra = sorted(set(visual) - set(own))
    mismatched = [k for k in own if k in visual and tuple(visual[k].shape) != tuple(own[k].shape)]
    if missing or extra or mismatched:
        raise ValueError(f"OpenCLIP conversion mismatch: missing {missing[:5]}, "
                         f"extra {extra[:5]}, mismatched {mismatched[:5]}")
    for k, v in visual.items():
        own[k].copy_(v)
    gm.text_state = text
    gm.logit_scale = logit_scale
    gm.text_activation = "quick_gelu" if is_openai else "gelu"
    log.info("OpenCLIP checkpoint loaded (%s flavor -> text activation %s)",
             "OpenAI" if is_openai else "open_clip/laion", gm.text_activation)


_COUNTER = "num_batches_tracked"


@torch.no_grad()
def _load_torch_state_dict(gm: GuideModel, state, path: str) -> None:
    """The JAX loader's rules (``_load_torch_state_dict``): a ``module.``
    prefix is stripped; a key the model lacks, or BatchNorm's update
    counter, is skipped; a shape that differs raises; loading nothing
    raises."""
    own = gm.module.state_dict()
    loaded = 0
    for key, value in state.items():
        if key.startswith("module."):
            key = key[len("module."):]
        if key.endswith(_COUNTER) or key not in own:
            continue
        value = torch.as_tensor(value)
        if value.shape != own[key].shape:
            raise ValueError(f"{path}: {key} has shape {list(value.shape)}, the "
                             f"model's is {list(own[key].shape)}")
        own[key].copy_(value)
        loaded += 1
    if loaded == 0:
        raise ValueError(f"no weights matched while loading {path}")


@torch.no_grad()
def _load_jax_npz(gm: GuideModel, path: str) -> None:
    """The JAX variables saved flat (``np.savez`` of ``{"params/conv1/kernel":
    ..., "batch_stats/bn1/mean": ...}``): every leaf of the model is read,
    mapped through ``weights/from_jax.py``'s guide key map and layout
    transforms; a missing leaf or a shape that differs raises, extra leaves
    are ignored, as the JAX loader ignores them."""
    from distdiff_tpu_torch.weights.from_jax import key_table

    flat = dict(np.load(path))
    own = gm.module.state_dict()
    for key, (jpath, shape, inverse) in key_table(gm.module.cfg).items():
        if jpath not in flat:
            raise KeyError(f"{path}: {key}: JAX leaf {jpath!r} is missing")
        arr = np.asarray(flat[jpath], np.float32)
        if arr.shape != shape:
            raise ValueError(f"{path}: JAX leaf {jpath!r} has shape {arr.shape}, "
                             f"expected {shape}")
        own[key].copy_(torch.from_numpy(np.ascontiguousarray(inverse(arr))))

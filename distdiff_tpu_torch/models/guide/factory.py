"""Guide-model factory (port of the ResNet part of
``distdiff_tpu/models/guide/factory.py``): ``GuideModel``, ``create_model``
for ``resnet50`` and ``tiny_resnet``, and ``load_weights``.

The module keeps torchvision's state-dict names, so a reference
``checkpoint.pth.tar`` (after stripping a ``module.`` prefix) loads key for
key. The other archs of the reference (``resnext50``, ``wideresnet50``,
``mobilenetv2``, ``open_clip_vit_b32``) wait for ROADMAP queue 1 item 8.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Union

import numpy as np
import torch

from distdiff_tpu_torch.device import resolve_device
from distdiff_tpu_torch.models.guide.resnet import (
    ResNet,
    resnet50_config,
    tiny_resnet_config,
)
from distdiff_tpu_torch.models.init import init_weights

ARCHS = ("resnet50", "tiny_resnet")
# the reference's other guide archs, not ported yet
TODO_ARCHS = ("resnext50", "wideresnet50", "mobilenetv2", "open_clip_vit_b32")
TODO = "ROADMAP queue 1 item 8"


@dataclasses.dataclass
class GuideModel:
    """A guide classifier and the two calls DistDiff needs."""

    arch: str
    module: ResNet
    feature_dim: int
    num_classes: int

    def encode_image(self, x: torch.Tensor, pooling: str = "avg") -> torch.Tensor:
        return self.module.encode_image(x, pooling)


def create_model(arch: str, num_classes: int, weight_path: Optional[str] = None,
                 input_size: int = 224,
                 device: Union[str, torch.device] = "cuda", pretrained: bool = False,
                 trainable: bool = False) -> GuideModel:
    """Build a guide and load ``weight_path`` into it (``load_weights``).

    The guide is frozen, in eval mode, with the weights as the module
    initialises them. ``trainable`` builds the trainer's classifier
    instead: in training mode, gradients on, its weights drawn as flax
    draws them (``init_weights``: lecun-normal kernels, zero biases, unit
    norm scales) before ``weight_path`` is loaded. ``pretrained`` without a
    ``weight_path`` changes nothing, as in the JAX factory (ImageNet
    weights come only from a file). ``input_size`` is the JAX factory's
    init size; a ResNet takes any input size, so it is unused."""
    del input_size, pretrained
    device = resolve_device(device)
    if arch == "resnet50":
        cfg = resnet50_config(num_classes)
    elif arch == "tiny_resnet":
        cfg = tiny_resnet_config(num_classes)
    elif arch in TODO_ARCHS:
        raise NotImplementedError(f"guide arch {arch!r} is not ported: {TODO}")
    else:
        raise ValueError(f"unknown arch {arch!r}; this port has {ARCHS}")
    if trainable:
        module = ResNet(cfg, device="cpu")
        init_weights(module, torch.Generator().manual_seed(0))
        module.to(device).train()
    else:
        module = ResNet(cfg, device=device)
        module.requires_grad_(False)
    gm = GuideModel(arch=arch, module=module, feature_dim=cfg.feature_dim,
                    num_classes=num_classes)
    if weight_path:
        load_weights(gm, weight_path)
    return gm


# ------------------------------------------------------------- checkpoints

def load_weights(gm: GuideModel, path: str) -> None:
    """Load guide weights from a torch ``checkpoint.pth.tar`` (the
    reference's format), a ``.safetensors`` file of the same state dict, or
    a numpy ``.npz`` of the JAX package's flat variable tree
    (``params/...``, ``batch_stats/...``)."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory (an orbax checkpoint of the JAX package); the port "
            "reads .pth.tar, .safetensors and .npz guide weights: save the variables "
            "as a flat .npz of the JAX tree")
    if path.endswith(".npz"):
        _load_jax_npz(gm, path)
        return
    state = _read_torch_state(path)
    if any(k.split("module.")[-1].startswith("visual.") for k in state):
        raise NotImplementedError(f"{path} is an OpenCLIP checkpoint; the OpenCLIP guide "
                                  f"is not ported: {TODO}")
    _load_torch_state_dict(gm, state, path)


def _read_torch_state(path: str) -> Dict[str, torch.Tensor]:
    if path.endswith(".safetensors"):
        from distdiff_tpu_torch.weights.safetensors import load_file

        return load_file(path)
    state = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return state


# the leaves the JAX loader takes; others (num_batches_tracked) are skipped
_LEAVES = ("weight", "bias", "running_mean", "running_var")


@torch.no_grad()
def _load_torch_state_dict(gm: GuideModel, state, path: str) -> None:
    """The JAX loader's rules (``_load_torch_state_dict``): a ``module.``
    prefix is stripped; a key the model lacks, or a leaf other than a
    weight, bias or running statistic, is skipped; a shape that differs
    raises; loading nothing raises."""
    own = gm.module.state_dict()
    loaded = 0
    for key, value in state.items():
        if key.startswith("module."):
            key = key[len("module."):]
        if key.rsplit(".", 1)[-1] not in _LEAVES or key not in own:
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

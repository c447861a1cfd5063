"""Guide-model factory (port of the ResNet part of
``distdiff_tpu/models/guide/factory.py``): ``GuideModel`` and
``create_model`` for ``resnet50`` and ``tiny_resnet``.

The module keeps torchvision's state-dict names, so a reference
``checkpoint.pth.tar`` (after stripping a ``module.`` prefix) loads with
``load_state_dict``.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

from distdiff_tpu_torch.device import resolve_device
from distdiff_tpu_torch.models.guide.resnet import (
    ResNet,
    resnet50_config,
    tiny_resnet_config,
)

ARCHS = ("resnet50", "tiny_resnet")


@dataclasses.dataclass
class GuideModel:
    """A guide classifier and the two calls DistDiff needs."""

    arch: str
    module: ResNet
    feature_dim: int
    num_classes: int

    def encode_image(self, x: torch.Tensor, pooling: str = "avg") -> torch.Tensor:
        return self.module.encode_image(x, pooling)


def create_model(arch: str, num_classes: int,
                 device: Union[str, torch.device] = "cuda") -> GuideModel:
    device = resolve_device(device)
    if arch == "resnet50":
        cfg = resnet50_config(num_classes)
    elif arch == "tiny_resnet":
        cfg = tiny_resnet_config(num_classes)
    else:
        raise ValueError(f"unknown arch {arch!r}; this port has {ARCHS}")
    module = ResNet(cfg, device=device)
    module.requires_grad_(False)
    return GuideModel(arch=arch, module=module, feature_dim=cfg.feature_dim,
                      num_classes=num_classes)

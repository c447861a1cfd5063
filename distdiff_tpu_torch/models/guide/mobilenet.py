"""MobileNetV2 guide model (port of ``distdiff_tpu/models/guide/mobilenet.py``;
the reference's ``mobilenetv2`` arch). Feature dim 1280.

Module names follow torchvision's ``mobilenet_v2``: ``features.0`` is the
stem (conv, BatchNorm), ``features.1`` to ``features.17`` the inverted
residuals (``features.1`` has no expand conv: ``conv.0.0``/``conv.0.1``
depthwise, ``conv.1`` project, ``conv.2`` its BatchNorm; the others
``conv.0`` expand, ``conv.1`` depthwise, ``conv.2`` project, ``conv.3``),
``features.18`` the head and ``classifier.1`` the Dense, so a torchvision
state dict loads key for key. Every 3x3 convolution pads 1 on each side,
as flax's ``padding=1`` does; BatchNorm has eps 1e-5 and flax's statistics
rule (``resnet.BatchNorm2d``). The JAX model has no dropout, so
``classifier.0`` (torchvision's Dropout) is an identity here.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn

from distdiff_tpu_torch.models.guide.resnet import BatchNorm2d

# (expansion t, out channels c, repeats n, stride s): the MobileNetV2 table
_V2_TABLE: Tuple[Tuple[int, int, int, int], ...] = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


@dataclasses.dataclass(frozen=True)
class MobileNetV2Config:
    num_classes: int = 1000
    width_mult: float = 1.0
    feature_dim: int = 1280


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _conv_bn(cin, cout, k, stride=1, groups=1, device=None) -> nn.Sequential:
    """torchvision's ``Conv2dNormActivation``: conv, BatchNorm, ReLU6."""
    return nn.Sequential(
        nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, groups=groups, bias=False,
                  device=device),
        BatchNorm2d(cout, device=device), nn.ReLU6())


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, expand: int, device=None):
        super().__init__()
        hidden = cin * expand
        layers = []
        if expand != 1:
            layers.append(_conv_bn(cin, hidden, 1, device=device))
        layers += [_conv_bn(hidden, hidden, 3, stride, groups=hidden, device=device),
                   nn.Conv2d(hidden, cout, 1, bias=False, device=device),
                   BatchNorm2d(cout, device=device)]
        self.conv = nn.Sequential(*layers)
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        h = self.conv(x)
        return h + x if self.residual else h


class MobileNetV2(nn.Module):
    def __init__(self, cfg: MobileNetV2Config, device=None):
        super().__init__()
        self.cfg = cfg
        cin = _make_divisible(32 * cfg.width_mult)
        features = [_conv_bn(3, cin, 3, 2, device=device)]
        for t, c, n, s in _V2_TABLE:
            cout = _make_divisible(c * cfg.width_mult)
            for bi in range(n):
                features.append(InvertedResidual(cin, cout, s if bi == 0 else 1, t,
                                                 device=device))
                cin = cout
        features.append(_conv_bn(cin, cfg.feature_dim, 1, device=device))
        self.features = nn.Sequential(*features)
        self.classifier = nn.Sequential(
            nn.Identity(), nn.Linear(cfg.feature_dim, cfg.num_classes, device=device))
        self.eval()

    def encode_image(self, x: torch.Tensor, pooling: str = "avg") -> torch.Tensor:
        """NHWC images -> pooled features ``[B, feature_dim]``."""
        h = self.features(x.float().permute(0, 3, 1, 2))
        if pooling == "avg":
            return h.mean(dim=(2, 3))
        if pooling == "max":
            return h.amax(dim=(2, 3))
        raise ValueError(f"unknown pooling: {pooling}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(self.encode_image(x, "avg"))


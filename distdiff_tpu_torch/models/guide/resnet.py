"""ResNet family for the guide classifier (port of
``distdiff_tpu/models/guide/resnet.py``): ResNet-50, ResNeXt-50 (32x4d),
Wide ResNet-50-2 and the test miniature, with torchvision's state-dict
names (``conv1``, ``bn1``, ``layer1.0.conv1``, ``layer1.0.downsample.0``,
``fc``), so ``resnet50``, ``resnext50_32x4d`` and ``wide_resnet50_2``
checkpoints load key for key.

The guide runs in eval mode (BatchNorm on its running statistics, eps
1e-5), in fp32; ``encode_image`` takes NHWC images and returns pooled
pre-logit features ``[B, feature_dim]``. In training mode (the trainer's
build, ``models/guide/factory.py``) BatchNorm normalises with the batch's
statistics and updates its running ones as flax does (``BatchNorm2d``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)
    base_width: int = 64
    groups: int = 1
    width_per_group: int = 64
    width_mult: float = 1.0  # wide_resnet50_2 doubles the bottleneck width
    num_classes: int = 1000

    @property
    def feature_dim(self) -> int:
        return self.base_width * (2 ** (len(self.stage_sizes) - 1)) * 4


def resnet50_config(num_classes: int) -> ResNetConfig:
    return ResNetConfig(num_classes=num_classes)


def resnext50_config(num_classes: int) -> ResNetConfig:
    return ResNetConfig(num_classes=num_classes, groups=32, width_per_group=4)


def wideresnet50_config(num_classes: int) -> ResNetConfig:
    return ResNetConfig(num_classes=num_classes, width_mult=2.0)


def tiny_resnet_config(num_classes: int) -> ResNetConfig:
    """CPU-testable miniature with the same topology."""
    return ResNetConfig(stage_sizes=(1, 1), base_width=8, num_classes=num_classes)


class BatchNorm2d(nn.BatchNorm2d):
    """torchvision's BatchNorm2d (its names, buffers and eval path) whose
    training pass updates the running statistics as flax's ``BatchNorm``
    (momentum 0.9) does: ``r = 0.9 r + 0.1 s`` with the batch's *biased*
    variance, where torch's own update takes the unbiased one (a factor
    n / (n - 1)). A frozen backbone (``train_fc``) updates them too, as the
    JAX package's step and the reference's linear probe do."""

    FLAX_MOMENTUM = 0.9

    def __init__(self, c, device=None):
        super().__init__(c, eps=1e-5, momentum=0.1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        # momentum 1 makes the fused kernel write the batch's mean and
        # unbiased variance into these two per-channel vectors
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        out = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        m = self.FLAX_MOMENTUM
        with torch.no_grad():
            self.running_mean.mul_(m).add_(mean, alpha=1 - m)
            self.running_var.mul_(m).add_(var, alpha=(1 - m) * (n - 1) / n)
            self.num_batches_tracked.add_(1)
        return out


def _bn(c, device):
    return BatchNorm2d(c, device=device)


class Bottleneck(nn.Module):
    def __init__(self, cfg: ResNetConfig, cin, planes, stride, device=None):
        super().__init__()
        out = planes * 4
        width = int(planes * (cfg.width_per_group / 64.0) * cfg.width_mult) * cfg.groups
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False, device=device)
        self.bn1 = _bn(width, device)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1, groups=cfg.groups,
                               bias=False, device=device)
        self.bn2 = _bn(width, device)
        self.conv3 = nn.Conv2d(width, out, 1, bias=False, device=device)
        self.bn3 = _bn(out, device)
        self.downsample = None
        if cin != out or stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, out, 1, stride=stride, bias=False, device=device),
                _bn(out, device))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(h + residual)


class ResNet(nn.Module):
    def __init__(self, cfg: ResNetConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.conv1 = nn.Conv2d(3, cfg.base_width, 7, stride=2, padding=3,
                               bias=False, device=device)
        self.bn1 = _bn(cfg.base_width, device)
        cin = cfg.base_width
        for si, n_blocks in enumerate(cfg.stage_sizes):
            planes = cfg.base_width * (2 ** si)
            blocks = []
            for bi in range(n_blocks):
                stride = 2 if (si > 0 and bi == 0) else 1
                blocks.append(Bottleneck(cfg, cin, planes, stride, device=device))
                cin = planes * 4
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(cin, cfg.num_classes, device=device)
        self.eval()

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Pre-pool feature map, NCHW."""
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        for si in range(len(self.cfg.stage_sizes)):
            h = getattr(self, f"layer{si + 1}")(h)
        return h

    def encode_image(self, x: torch.Tensor, pooling: str = "avg") -> torch.Tensor:
        """NHWC images -> pooled features ``[B, C]``."""
        h = self.features(x.float().permute(0, 3, 1, 2))
        if pooling == "avg":
            return h.mean(dim=(2, 3))
        if pooling == "max":
            return h.amax(dim=(2, 3))
        raise ValueError(f"unknown pooling: {pooling}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.encode_image(x, "avg"))

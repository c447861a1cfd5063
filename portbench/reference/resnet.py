"""Plain fp32 ResNet-50 guide (He et al. 2016, torchvision's layout and
state-dict names), in eval mode: BatchNorm on its running statistics. The
guide's features are the average-pooled output of the last stage."""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int):
        super().__init__()
        out = planes * 4
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out)
        self.downsample = None
        if cin != out or stride != 1:
            self.downsample = nn.Sequential(nn.Conv2d(cin, out, 1, stride=stride, bias=False),
                                            nn.BatchNorm2d(out))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return F.relu(h + (x if self.downsample is None else self.downsample(x)))


class ResNet(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        width = cfg["base_width"]
        self.conv1 = nn.Conv2d(3, width, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        cin = width
        for si, n_blocks in enumerate(cfg["stage_sizes"]):
            planes = width * 2 ** si
            blocks = []
            for bi in range(n_blocks):
                blocks.append(Bottleneck(cin, planes, 2 if si > 0 and bi == 0 else 1))
                cin = planes * 4
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))
        self.n_stages = len(cfg["stage_sizes"])
        self.fc = nn.Linear(cin, cfg["num_classes"])
        self.eval()

    def features(self, images):
        """NHWC images -> ``[B, C]`` average-pooled features."""
        h = F.relu(self.bn1(self.conv1(images.permute(0, 3, 1, 2))))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        for si in range(self.n_stages):
            h = getattr(self, f"layer{si + 1}")(h)
        return h.mean(dim=(2, 3))

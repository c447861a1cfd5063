"""The reference modules of a configuration file."""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference.resnet import ResNet
from portbench.reference.unet import UNet
from portbench.reference.vae import AutoencoderKL


def build(cfg: dict, device="meta") -> Dict[str, torch.nn.Module]:
    """{"unet", "vae", "guide"}, frozen, in eval mode, on ``device`` (the
    meta device gives the names and shapes without memory)."""
    with torch.device(device):
        mods = {"unet": UNet(cfg["unet"]), "vae": AutoencoderKL(cfg["vae"]),
                "guide": ResNet(cfg["guide"])}
    for m in mods.values():
        m.requires_grad_(False).eval()
    return mods

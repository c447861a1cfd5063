"""Device resolution for the port's entry points.

Entry points default to ``device="cuda"``. On a host without a GPU they
raise instead of continuing quietly on the CPU; the CPU is used only when a
caller asks for it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def disable_tf32() -> None:
    """The guide ResNet-50 and the energy run in fp32. TF32 keeps about
    three decimal digits, so fp32 matmuls and cuDNN convolutions are pinned
    to full fp32 (cuDNN defaults to TF32 for convolutions)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

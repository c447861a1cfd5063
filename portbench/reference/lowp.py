"""The reference one precision step below the bf16 the configurations
state: every product's operands (the inputs and weights of each convolution
and linear layer, and the two attention products' operands) rounded to fp8
e4m3 with a per-tensor scale (the tensor's largest magnitude onto fp8's
448), everything else in fp32. It stands in for the program as the control
of the guided cells."""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn

from portbench.reference import layers

FP8_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


@contextlib.contextmanager
def fp8_products(mods):
    """The reference modules ``mods`` computing their products on fp8
    operands inside the block; their weights are rounded in place."""
    hooks = []
    for m in mods:
        for sub in m.modules():
            if isinstance(sub, (nn.Conv2d, nn.Linear)):
                with torch.no_grad():
                    sub.weight.copy_(fp8(sub.weight))
                hooks.append(sub.register_forward_pre_hook(
                    lambda mod, args: (fp8(args[0]),) + tuple(args[1:])))
    layers.OPERAND_ROUNDING = fp8
    try:
        yield
    finally:
        layers.OPERAND_ROUNDING = None
        for h in hooks:
            h.remove()

"""Attention ops (port of ``distdiff_tpu/ops/attention.py``).

``attention`` takes ``[B, T, H, D]`` tensors and ``attention_hm`` head-major
``[B, H, T, D]`` ones. The dispatch is the reference's, by kv length
(``attention.py:118-130,177-186``): attention over at most 256 kv tokens
(the 77-token cross-attention, the 16^2 and 8^2 self-attention) takes the
plain fp32-softmax path on every device; longer kv on a CUDA tensor takes
the flash kernels (``ops/flash.py``), and on the CPU the plain path.

Tensor parallelism (the reference's ``set_tp_attention`` /
``tp_sharded_attention``, ``attention.py:52-130,155-185``): while a mesh is
set, a call that takes the kernels splits its heads over the model group
of the mesh that holds q's device, and each device of the group runs the
kernel on its local heads, with no collective inside; the outputs come
back to q's device. When the head count does not divide the group, the
heads stay together and the call runs once, on q's device (the
reference's head-replicated compute). The batch arrives already split
over the ``data`` axis (``SplitExpand`` splits it). The UNet's
transformer blocks in their tensor-parallel form (``parallel/tp.py``)
hold their heads sharded already and call ``local_attention_hm`` on each
device's own heads.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List

import torch

from distdiff_tpu_torch.ops import flash

SMALL_KV = 256

_TP_CTX = {"mesh": None, "data_axis": None, "model_axis": None}


def set_tp_attention(mesh, data_axis: str = "data", model_axis: str = "model") -> None:
    """Route the kernel calls of ``attention``/``attention_hm`` through the
    mesh's model groups until reset (``mesh=None``): the process-lifetime
    form of ``tp_sharded_attention``, for the CLI."""
    if mesh is None:
        _TP_CTX.update(mesh=None, data_axis=None, model_axis=None)
    else:
        _TP_CTX.update(mesh=mesh, data_axis=data_axis, model_axis=model_axis)


@contextlib.contextmanager
def tp_sharded_attention(mesh, data_axis: str = "data", model_axis: str = "model"):
    """``set_tp_attention`` for the calls inside the block; the previous
    setting is restored on exit."""
    old = dict(_TP_CTX)
    _TP_CTX.update(mesh=mesh, data_axis=data_axis, model_axis=model_axis)
    try:
        yield
    finally:
        _TP_CTX.update(old)


def model_group(mesh, device, model_axis: str = "model") -> List[torch.device]:
    """The devices along ``model_axis`` of the first mesh row that holds
    ``device`` (the row's first device first)."""
    import numpy as np

    k = mesh.axis_names.index(model_axis)
    rows = np.moveaxis(mesh.devices, k, -1).reshape(-1, mesh.shape[model_axis])
    for row in rows:
        if torch.device(device) in list(row):
            return list(row)
    raise ValueError(f"{device} is not a device of {mesh}")


def _tp_attention(q, k, v, mesh, model_axis: str, head_dim: int, local: Callable):
    """``local`` on each model device's heads of q, k and v (split along
    ``head_dim``), the outputs concatenated on q's device."""
    from distdiff_tpu_torch.parallel.mesh import all_gather

    group = model_group(mesh, q.device, model_axis)
    h, n = q.shape[head_dim], len(group)
    if h % n or h < n:  # the heads stay together: one call, on q's device
        return local(q, k, v)
    hs = h // n
    outs = [local(*(t.narrow(head_dim, j * hs, hs).to(dev) for t in (q, k, v)))
            for j, dev in enumerate(group)]
    return all_gather(outs, head_dim, q.device)


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain attention with an fp32 softmax, ``[B, T, H, D]`` layout."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(logits * scale, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def xla_attention_hm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain attention with an fp32 softmax, head-major ``[B, H, T, D]``."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    probs = torch.softmax(logits * scale, dim=-1)
    return torch.matmul(probs.to(v.dtype), v).to(q.dtype)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The dispatch on q's device alone (no tensor-parallel routing)."""
    if k.shape[1] > SMALL_KV and q.is_cuda:
        return flash.flash_attention(q, k, v)
    return xla_attention(q, k, v)


def local_attention_hm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``local_attention`` over head-major ``[B, H, T, D]`` tensors."""
    if k.shape[2] > SMALL_KV and q.is_cuda:
        return flash.flash_attention_hm(q, k, v)
    return xla_attention_hm(q, k, v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if _TP_CTX["mesh"] is not None and k.shape[1] > SMALL_KV and q.is_cuda:
        return _tp_attention(q, k, v, _TP_CTX["mesh"], _TP_CTX["model_axis"], 2,
                             flash.flash_attention)
    return local_attention(q, k, v)


def attention_hm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if _TP_CTX["mesh"] is not None and k.shape[2] > SMALL_KV and q.is_cuda:
        return _tp_attention(q, k, v, _TP_CTX["mesh"], _TP_CTX["model_axis"], 1,
                             flash.flash_attention_hm)
    return local_attention_hm(q, k, v)

"""Tensor-parallel sharding of the diffusion UNet (port of
``distdiff_tpu/parallel/tp.py``).

The reference's rules over a 2-D ``(data, model)`` mesh, written over the
port's diffusers names, where a ``Linear.weight`` is ``[out, in]`` (the
transpose of the flax kernel):

  * attention ``to_q``/``to_k``/``to_v`` inside ``transformer_blocks``:
    column-parallel, ``P('model', None)``: each model device holds a
    slice of the heads;
  * attention ``to_out.0`` and the feed-forward's ``net.2``: row-parallel,
    ``P(None, 'model')``: each device's partial product, then ONE
    all-reduce (a sum of the partials) a layer;
  * everything else replicated: convolutions, norms, embeddings, and the
    GEGLU's ``net.0.proj`` (the reference's rule matches a kernel by the
    name of its parent, and that kernel's parent is ``proj``, not
    ``net_0``: it stays whole, and each device takes its slice of the
    GEGLU's output for ``net.2``).

``unet_param_shardings(mesh, unet)`` gives the ``NamedSharding`` of every
parameter; ``tensor_parallel(unet, mesh)`` turns the UNet into that form
for one model group of the mesh. In that form a transformer block's
attention computes q, k and v on each device from its weight shard, runs
the attention on each device's own heads with no collective
(``ops.attention.local_attention_hm``: the flash kernels on the card),
and sums the devices' ``to_out`` partial products on the group's first
device, where the replicated layers run. A block whose head count does not
divide the group gathers q, k and v there and runs its attention once (the
reference's head-replicated compute, ``ops/attention.py:92-94``). Under
int8 (``ops/quant.py``) a row-parallel ``net.2`` quantizes with the global
scales (the activation's over the whole tensor, the weight's over each
whole output row) and sums the int32 partial products, so it equals the
unsharded layer.

Shards on the device that holds the weight are views of it: replicas on
one card share one copy, and the state dict keeps its names and tensors.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from distdiff_tpu_torch.ops import attention as attn_op
from distdiff_tpu_torch.ops import quant
from distdiff_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    NamedSharding,
    P,
    all_gather,
    all_reduce,
    data_groups,
    local_devices,
)

MODEL_AXIS = "model"

# Linear layers inside transformer_blocks, by the end of their name
_COL_PARALLEL = ("to_q", "to_k", "to_v")
_ROW_PARALLEL = ("to_out.0", "net.2")


def make_tp_mesh(n_data: int, n_model: int, devices: Optional[Sequence] = None) -> Mesh:
    devices = list(devices) if devices is not None else local_devices()
    if len(devices) < n_data * n_model:
        raise ValueError(f"a {n_data} x {n_model} mesh over {len(devices)} devices")
    grid = np.empty(n_data * n_model, dtype=object)
    grid[:] = devices[:n_data * n_model]
    return Mesh(grid.reshape(n_data, n_model), (DATA_AXIS, MODEL_AXIS))


def _spec_for(name: str) -> P:
    if "transformer_blocks." not in name:
        return P()
    layer, leaf = name.rsplit(".", 1)
    if layer.endswith(_COL_PARALLEL):
        return P(MODEL_AXIS, None) if leaf == "weight" else P(MODEL_AXIS)
    if layer.endswith(_ROW_PARALLEL) and leaf == "weight":
        return P(None, MODEL_AXIS)
    return P()  # replicated


def unet_param_shardings(mesh: Mesh, params: Any) -> Dict[str, NamedSharding]:
    """``{name: NamedSharding}`` for a UNet's parameters (a module or a
    state dict using the port's transformer names)."""
    names = params.keys() if isinstance(params, dict) else \
        [n for n, _ in params.named_parameters()]
    return {n: NamedSharding(mesh, _spec_for(n)) for n in names}


def _shards(w: torch.Tensor, dim: int, group: Sequence[torch.device]) -> List[torch.Tensor]:
    """``w`` in ``len(group)`` slices along ``dim``, slice j on group[j]
    (a view of ``w`` where it lies there already)."""
    n = len(group)
    if w.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(w.shape)} does not split over {n} devices")
    s = w.shape[dim] // n
    return [w.detach().narrow(dim, j * s, s).to(dev) for j, dev in enumerate(group)]


def _row_parallel(xs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor], bias, dt,
                  home: torch.device) -> torch.Tensor:
    """Row-parallel linear: device j's ``xs[j] @ ws[j]^T``, the partials
    summed on ``home`` (the all-reduce), then the bias once."""
    out = all_reduce([F.linear(x.to(dt), w.to(dt)) for x, w in zip(xs, ws)], home)
    return out if bias is None else out + bias.to(dt)


def _row_parallel_int8(x: torch.Tensor, ws: Sequence[torch.Tensor], bias, dt,
                       group: Sequence[torch.device]) -> torch.Tensor:
    """The int8 route of a row-parallel linear: x (whole, on the group's
    first device) quantized with its global scale, each weight row's scale
    the max over the shards, the int32 partial products summed (exact),
    then one rescale: the unsharded ``qdot``'s result."""
    home = x.device
    qx, sx = quant.quant_act(x)
    amax = torch.stack([w.float().abs().amax(dim=1).to(home) for w in ws]).amax(dim=0)
    sw = torch.clamp_min(quant._per_level(amax), 1e-8)
    qcols = torch.chunk(qx.reshape(-1, x.shape[-1]), len(ws), dim=1)
    acc = all_reduce([quant.int_mm(qc.to(dev), quant.quantize_w(w, sw.to(dev)))
                      for qc, w, dev in zip(qcols, ws, group)], home)
    y = quant.rescale(acc, sx, sw, dt).reshape(*x.shape[:-1], ws[0].shape[0])
    return y if bias is None else y + bias.to(dt)


class TPAttention(nn.Module):
    """An ``Attention`` in its tensor-parallel form over ``group``. It keeps
    the layers it was made from (the same parameters and names) and reads
    their weights through per-device shards."""

    def __init__(self, attn: nn.Module, group: Sequence[torch.device]):
        super().__init__()
        self.to_q, self.to_k, self.to_v, self.to_out = attn.to_q, attn.to_k, attn.to_v, attn.to_out
        self.heads, self.head_dim = attn.heads, attn.head_dim
        self.group = list(group)
        n = len(self.group)
        self.wq, self.wk, self.wv = (_shards(lin.weight, 0, self.group)
                                     for lin in (attn.to_q, attn.to_k, attn.to_v))
        self.wo = _shards(attn.to_out[0].weight, 1, self.group)
        self.local_heads = self.heads % n == 0 and self.heads >= n

    def forward(self, x, context=None):
        ctx = x if context is None else context
        dt = self.to_q.compute_dtype
        home = x.device
        b, tq, _ = x.shape
        tk = ctx.shape[1]
        group = self.group
        xs = [x.to(dev) for dev in group]
        cs = xs if context is None else [ctx.to(dev) for dev in group]
        q = [F.linear(a.to(dt), w.to(dt)) for a, w in zip(xs, self.wq)]
        k = [F.linear(a.to(dt), w.to(dt)) for a, w in zip(cs, self.wk)]
        v = [F.linear(a.to(dt), w.to(dt)) for a, w in zip(cs, self.wv)]
        d = self.head_dim
        if self.local_heads:  # each device's own heads, no collective
            hl = self.heads // len(group)
            outs = [attn_op.local_attention_hm(qj.view(b, tq, hl, d).transpose(1, 2),
                                               kj.view(b, tk, hl, d).transpose(1, 2),
                                               vj.view(b, tk, hl, d).transpose(1, 2))
                    .transpose(1, 2).reshape(b, tq, hl * d)
                    for qj, kj, vj in zip(q, k, v)]
        else:  # gather the heads, one call on the group's first device
            h = self.heads
            qf, kf, vf = (all_gather(t, -1, home) for t in (q, k, v))
            o = attn_op.local_attention_hm(qf.view(b, tq, h, d).transpose(1, 2),
                                           kf.view(b, tk, h, d).transpose(1, 2),
                                           vf.view(b, tk, h, d).transpose(1, 2))
            o = o.transpose(1, 2).reshape(b, tq, h * d)
            outs = [part.to(dev) for part, dev in zip(torch.chunk(o, len(group), -1), group)]
        return _row_parallel(outs, self.wo, self.to_out[0].bias, dt, home)


class TPFeedForward(nn.Module):
    """A ``FeedForward`` in its tensor-parallel form: the GEGLU whole on the
    group's first device, ``net.2`` row-parallel."""

    def __init__(self, ff: nn.Module, group: Sequence[torch.device]):
        super().__init__()
        self.net = ff.net
        self.group = list(group)
        self.w2 = _shards(ff.net[2].weight, 1, self.group)

    def forward(self, x):
        h = self.net[0](x)
        lin = self.net[2]
        dt = lin.compute_dtype
        if quant.int8_enabled():
            return _row_parallel_int8(h, self.w2, lin.bias, dt, self.group)
        parts = [p.to(dev) for p, dev in zip(torch.chunk(h, len(self.group), -1), self.group)]
        return _row_parallel(parts, self.w2, lin.bias, dt, x.device)


def _check_specs(unet: nn.Module, shardings: Optional[Dict[str, NamedSharding]]) -> None:
    """The form below implements ``_spec_for``'s rules; other shardings
    are refused rather than ignored."""
    if shardings is None:
        return
    for name, _ in unet.named_parameters():
        sh = shardings.get(name)
        if sh is not None and tuple(sh.spec) != tuple(_spec_for(name)):
            raise ValueError(f"{name}: sharding {sh.spec!r}, the tensor-parallel form "
                             f"implements {_spec_for(name)!r}")


def tensor_parallel(unet: nn.Module, mesh: Mesh, row: int = 0,
                    shardings: Optional[Dict[str, NamedSharding]] = None) -> nn.Module:
    """Turn ``unet`` (in place; returned) into its tensor-parallel form over
    the model group of data index ``row`` of ``mesh``: every
    ``BasicTransformerBlock``'s ``attn1``, ``attn2`` and ``ff``. Convert
    after the weights are final (loaded, cast, merged): the shards are
    views of them. A UNet already in that form is returned as it is."""
    from distdiff_tpu_torch.models.layers import BasicTransformerBlock

    _check_specs(unet, shardings)
    group = data_groups(mesh)[row]
    for m in unet.modules():
        if isinstance(m, BasicTransformerBlock) and not isinstance(m.ff, TPFeedForward):
            m.attn1 = TPAttention(m.attn1, group)
            m.attn2 = TPAttention(m.attn2, group)
            m.ff = TPFeedForward(m.ff, group)
    return unet

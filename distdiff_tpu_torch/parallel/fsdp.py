"""FSDP (ZeRO-3) parameter sharding for the classifier's train step (port
of ``distdiff_tpu/parallel/fsdp.py``).

Every large parameter splits along its largest dim that the mesh's ``data``
axis divides; each device holds its shard and that shard's optimiser state
(the SGD momentum, the accumulation). The step gathers each parameter at
use (an ``all_gather`` on each device, recorded by autograd), and autograd
sums the gathered parameters' gradients back into the shards: the
reduce-scatter. Small parameters (below ``MIN_SHARD_ELEMS``) stay whole, on
the mesh's first device, and are broadcast at use. The batch splits over
the same axis (``train.classifier``'s mesh step).

Usage::

    step, state = make_fsdp_train_step(module, tx, state, mesh=mesh)
    state, metrics = step(state, images, targets, mask)

``shard_state`` never aliases its input: the sharded state's tensors are
fresh, so stepping it leaves the state it came from as it was.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from distdiff_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    NamedSharding,
    P,
    all_gather,
    make_mesh,
)

# Below this size a parameter stays whole: sharding a [64] bias buys nothing
# and costs a gather (2**14 elements, 64 KiB of fp32).
MIN_SHARD_ELEMS = 2 ** 14


def _leaf_spec(shape, n: int, axis: str, min_elems: int) -> P:
    size = int(np.prod(shape)) if shape else 0
    if len(shape) == 0 or size < min_elems:
        return P()
    # the largest dim the mesh divides (the first of equal ones)
    order = sorted(range(len(shape)), key=lambda i: shape[i], reverse=True)
    for i in order:
        if shape[i] % n == 0:
            parts: list = [None] * len(shape)
            parts[i] = axis
            return P(*parts)
    return P()  # no dim divides the mesh: whole


def _named_tensors(tree: Any) -> Dict[str, torch.Tensor]:
    if isinstance(tree, dict):
        return tree
    module = getattr(tree, "module", tree)  # a TrainState, or a module
    return dict(module.named_parameters())


def fsdp_sharding(tree: Any, mesh: Mesh, axis: str = DATA_AXIS,
                  min_shard_elems: int = MIN_SHARD_ELEMS) -> Dict[str, NamedSharding]:
    """``{name: NamedSharding}`` over the parameters of ``tree`` (a
    ``TrainState``, a module or a dict of tensors). The rule is a function
    of a tensor's shape alone, so a parameter's gradient and optimiser
    state shard as it does."""
    n = mesh.shape[axis]
    return {name: NamedSharding(mesh, _leaf_spec(tuple(t.shape), n, axis, min_shard_elems))
            for name, t in _named_tensors(tree).items()}


@dataclasses.dataclass
class FSDPState:
    """A ``TrainState`` in the FSDP layout: ``module`` (a copy, its
    parameters on the meta device) holds the buffers (BatchNorm's
    statistics) and the structure; ``shards[name]`` the
    parameter's per-device shards (one whole tensor on the first device
    when it is not split); ``tx`` steps the shards."""

    module: torch.nn.Module
    shards: Dict[str, List[torch.Tensor]]
    shardings: Dict[str, NamedSharding]
    tx: Any

    def params_on(self, device) -> Dict[str, torch.Tensor]:
        """Every parameter gathered on ``device``."""
        out = {}
        for name, parts in self.shards.items():
            spec = self.shardings[name].spec
            out[name] = parts[0].to(device) if len(parts) == 1 else \
                all_gather(parts, [a is not None for a in spec].index(True), device)
        return out

    @torch.no_grad()
    def unshard(self) -> torch.nn.Module:
        """A copy of the module holding the gathered parameters, on the
        mesh's first device (for the eval step and checkpoints)."""
        home = next(iter(self.shardings.values())).mesh.device_list()[0]
        full = {k: v.detach().clone() for k, v in self.params_on(home).items()}
        module = copy.deepcopy(self.module)
        module.load_state_dict(full, strict=False, assign=True)
        return module


def _shard(t: torch.Tensor, sharding: NamedSharding) -> List[torch.Tensor]:
    """Fresh tensors: ``t``'s shards along the data axis, or one whole copy
    on the mesh's first device."""
    mesh = sharding.mesh
    devices = mesh.device_list()
    if all(a is None for a in sharding.spec):
        return [t.detach().to(devices[0], copy=True)]
    dim = [a is not None for a in sharding.spec].index(True)
    return [part.detach().to(dev, copy=True).contiguous()
            for part, dev in zip(torch.chunk(t, len(devices), dim), devices)]


def shard_state(state: Any, mesh: Mesh, axis: str = DATA_AXIS,
                min_shard_elems: int = MIN_SHARD_ELEMS,
                shardings: Optional[Dict[str, NamedSharding]] = None) -> FSDPState:
    """``state`` (a ``TrainState``) in its FSDP layout over ``mesh``'s
    ``axis``, its optimiser's momentum and accumulation sharded with each
    parameter. Nothing of the result aliases ``state``."""
    from distdiff_tpu_torch.train.classifier import Optimizer

    if mesh.axis_names != (axis,):
        raise ValueError(f"FSDP takes a 1-d {axis!r} mesh, got {mesh}")
    shardings = shardings or fsdp_sharding(state, mesh, axis, min_shard_elems)
    # the module's structure and fresh buffers; its parameters live in the
    # shards alone (meta tensors here)
    memo = {id(p): torch.nn.Parameter(torch.empty(p.shape, dtype=p.dtype, device="meta"),
                                      requires_grad=p.requires_grad)
            for p in state.module.parameters()}
    module = copy.deepcopy(state.module, memo)
    shards: Dict[str, List[torch.Tensor]] = {}
    for name, p in state.module.named_parameters():
        shards[name] = [s.requires_grad_(p.requires_grad) for s in _shard(p, shardings[name])]
    old = state.tx
    name_of = {id(p): name for name, p in state.module.named_parameters()}
    # the shards in the module's order: the old optimiser's order, split
    tx = Optimizer(module, old.cfg, 1, params=[s for parts in shards.values() for s in parts])
    tx.decay_steps, tx.count, tx.mini_step = old.decay_steps, old.count, old.mini_step
    for p in old.params:
        buf = old.sgd.state.get(p, {}).get("momentum_buffer")
        if buf is not None:
            name = name_of[id(p)]
            for s, part in zip(shards[name], _shard(buf, shardings[name])):
                tx.sgd.state[s]["momentum_buffer"] = part
    if old.acc is not None:
        tx.acc = [part for p, a in zip(old.params, old.acc)
                  for part in _shard(a, shardings[name_of[id(p)]])]
    return FSDPState(module=module, shards=shards, shardings=shardings, tx=tx)


def make_fsdp_train_step(module: torch.nn.Module, tx, state, mesh: Optional[Mesh] = None,
                         min_shard_elems: int = MIN_SHARD_ELEMS, **step_kwargs):
    """The FSDP counterpart of ``train.classifier.make_train_step``:
    ``(step, sharded_state)``, the step taking and returning an
    ``FSDPState`` (``step(state, images, targets, mask) -> (state,
    metrics)``). ``state`` is copied into the sharded layout, never
    aliased."""
    from distdiff_tpu_torch.train.classifier import make_train_step

    mesh = mesh if mesh is not None else make_mesh()
    shardings = fsdp_sharding(state, mesh, min_shard_elems=min_shard_elems)
    step = make_train_step(module, tx, mesh=mesh, state_shardings=shardings, **step_kwargs)
    return step, shard_state(state, mesh, shardings=shardings)

"""Pipeline parallelism for the diffusion UNet (port of
``distdiff_tpu/parallel/pp.py``).

The UNet's forward runs as S contiguous segments of its unit list
(``UNet2DConditionModel.forward(segment=(a, b), skips=...)``: conv_in, N
down levels, mid, N up groups, conv_out), each stage on its own device
group. Stages are cut by an exact min-max DP over parameter bytes
(``plan_boundaries``): balanced by weight memory, the thing pipeline
parallelism shards. The carried state between stages is ``(hidden,
skips)``; skip tensors made by early down levels travel through later
stages to the up group that takes them.

A stage's modules live on its group's devices (``PipelinedUNet``): on a
group of the UNet's own device they are the UNet's modules themselves, on
another device copies of them. Within a group the batch splits over its
devices (pipeline x data). ``microbatched`` enqueues its microbatches depth
first; CUDA's asynchronous launches let stage s run microbatch m while
stage s - 1 runs m + 1 on another card, with no scheduler of its own.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from distdiff_tpu_torch.parallel.mesh import all_gather, canonical_device, local_devices, split

# The time embedding feeds every resnet, and SDXL's additive conditioning
# adds into it: every stage holds them (under 0.5% of the parameters).
_SHARED = ("time_embedding", "add_embedding")


def n_units(n_blocks: int) -> int:
    return 2 * n_blocks + 3


def unit_of_param(name: str, n_blocks: int) -> Optional[int]:
    """The pipeline unit that owns a UNet parameter, or a top-level module
    (``conv_in``, ``down_blocks.i``, ``mid_block``, ``up_blocks.i``,
    ``conv_norm_out``, ``conv_out``); None for the modules every stage
    holds (``_SHARED``)."""
    parts = name.split(".")
    top = parts[0]
    if top in _SHARED:
        return None
    if top == "conv_in":
        return 0
    if top == "down_blocks":
        return 1 + int(parts[1])
    if top == "mid_block":
        return n_blocks + 1
    if top == "up_blocks":
        return n_blocks + 2 + int(parts[1])
    if top in ("conv_norm_out", "conv_out"):
        return 2 * n_blocks + 2
    raise ValueError(f"unknown UNet parameter: {name!r}")


def _state(params: Any) -> Dict[str, torch.Tensor]:
    return params if isinstance(params, dict) else dict(params.named_parameters())


def plan_boundaries(params: Any, n_blocks: int, n_stages: int) -> List[Tuple[int, int]]:
    """Contiguous unit ranges minimising the largest stage's parameter
    bytes, by an exact DP (a UNet has at most 2N + 3 units). ``params``: a
    UNet or its parameters by name."""
    nu = n_units(n_blocks)
    cost = [0] * nu
    for name, t in _state(params).items():
        u = unit_of_param(name, n_blocks)
        if u is not None:
            cost[u] += t.numel() * t.element_size()
    prefix = np.concatenate([[0], np.cumsum(cost)])

    def span(a, b):  # cost of units [a, b)
        return prefix[b] - prefix[a]

    inf = float("inf")
    # best[s][b]: the least max-stage cost of units [0, b) in s stages
    best = [[inf] * (nu + 1) for _ in range(n_stages + 1)]
    cut = [[0] * (nu + 1) for _ in range(n_stages + 1)]
    best[0][0] = 0.0
    for s in range(1, n_stages + 1):
        for b in range(s, nu + 1):
            for a in range(s - 1, b):
                v = max(best[s - 1][a], span(a, b))
                if v < best[s][b]:
                    best[s][b], cut[s][b] = v, a
    bounds, b = [], nu
    for s in range(n_stages, 0, -1):
        a = cut[s][b]
        bounds.append((a, b))
        b = a
    bounds.reverse()
    assert bounds[0][0] == 0 and bounds[-1][1] == nu
    return bounds


def split_unet_params(params: Any, boundaries: Sequence[Tuple[int, int]],
                      n_blocks: int) -> List[Dict[str, torch.Tensor]]:
    """Each stage's parameters by name (the shared modules' in every one)."""
    state = _state(params)
    stages = []
    for a, b in boundaries:
        stages.append({name: t for name, t in state.items()
                       if unit_of_param(name, n_blocks) is None
                       or a <= unit_of_param(name, n_blocks) < b})
    return stages


def _place(module: nn.Module, device: torch.device) -> nn.Module:
    """``module`` itself when its parameters lie on ``device``, else a copy
    there."""
    p = next(module.parameters(), None)
    if p is None or p.device == device:
        return module
    return copy.deepcopy(module).to(device)


def _stage_module(unet: nn.Module, a: int, b: int, device: torch.device) -> nn.Module:
    """A view of ``unet`` whose units [a, b) and shared modules are on
    ``device`` (the UNet itself when they are there already)."""
    nb = len(unet.config.block_out_channels)
    if all(_place(m, device) is m for m in unet.children()):
        return unet
    view = copy.copy(unet)
    view._modules = dict(unet._modules)
    for name, m in unet._modules.items():
        if m is None:
            continue
        if isinstance(m, nn.ModuleList):  # down_blocks, up_blocks
            view._modules[name] = nn.ModuleList(
                [_place(blk, device) if a <= unit_of_param(f"{name}.{i}", nb) < b else blk
                 for i, blk in enumerate(m)])
        else:
            u = unit_of_param(name, nb)
            if u is None or a <= u < b:
                view._modules[name] = _place(m, device)
    return view


class PipelinedUNet:
    """The UNet forward in ``n_stages`` stages over as many device groups.

    ``devices`` (default ``local_devices()``) split evenly into the stage
    groups; a device may repeat (``[cuda:0] * 2``: two stages on one card,
    holding one copy of the weights). ``boundaries`` default to
    ``plan_boundaries``."""

    def __init__(self, unet: nn.Module, n_stages: int = 2,
                 devices: Optional[Sequence] = None,
                 boundaries: Optional[Sequence[Tuple[int, int]]] = None):
        devices = [canonical_device(d)
                   for d in (local_devices() if devices is None else devices)]
        assert n_stages >= 1 and len(devices) >= n_stages
        nb = len(unet.config.block_out_channels)
        self.unet = unet
        self.n_stages = n_stages
        self.boundaries = list(boundaries) if boundaries is not None else \
            plan_boundaries(unet, nb, n_stages)
        assert len(self.boundaries) == n_stages
        per = len(devices) // n_stages
        self.groups = [devices[i * per:(i + 1) * per] for i in range(n_stages)]
        # one module view per distinct device of each group
        self.stages = [{dev: _stage_module(unet, a, b, dev) for dev in group}
                       for (a, b), group in zip(self.boundaries, self.groups)]
        self.final = [b == n_units(nb) for _, b in self.boundaries]

    def _run_stage(self, i: int, x, skips, t, ctx, added):
        """Stage i over its group: the batch split over the group's devices
        when it divides (else whole on the first), the results gathered on
        the group's first device."""
        group = self.groups[i]
        n = len(group) if x.shape[0] % len(group) == 0 else 1

        def parts(tensor):
            return [None] * n if tensor is None else split(tensor, n, 0)

        xs, cs, adds = parts(x), parts(ctx), parts(added)
        ss = list(zip(*[split(s, n, 0) for s in skips])) if skips else [()] * n
        ts = split(t, n, 0) if t.shape[0] == x.shape[0] else [t] * n
        outs = []
        for j in range(n):
            dev = group[j]
            kw = {} if adds[j] is None else {"added_cond": adds[j].to(dev)}
            outs.append(self.stages[i][dev](
                xs[j].to(dev), ts[j].to(dev), cs[j].to(dev),
                segment=self.boundaries[i], skips=tuple(s.to(dev) for s in ss[j]), **kw))
        home = group[0]
        if self.final[i]:
            return all_gather(outs, 0, home)
        hx = all_gather([o[0] for o in outs], 0, home)
        hs = tuple(all_gather([o[1][k] for o in outs], 0, home)
                   for k in range(len(outs[0][1])))
        return hx, hs

    def __call__(self, sample: torch.Tensor, timestep, context: torch.Tensor,
                 added_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        x, skips = sample, ()
        t = torch.as_tensor(timestep, device=sample.device).reshape(-1)
        for i in range(self.n_stages):
            out = self._run_stage(i, x, skips, t, context, added_cond)
            if self.final[i]:
                return out
            x, skips = out

    def microbatched(self, sample: torch.Tensor, timestep, context: torch.Tensor,
                     added_cond: Optional[torch.Tensor] = None,
                     n_micro: Optional[int] = None) -> torch.Tensor:
        """The batch in ``n_micro`` microbatches (default: the stage count),
        enqueued depth first, the outputs concatenated on the last stage's
        first device."""
        b = sample.shape[0]
        n_micro = n_micro or self.n_stages
        assert b % n_micro == 0, (b, n_micro)
        mb = b // n_micro
        t = torch.as_tensor(timestep, device=sample.device).reshape(-1)
        outs = []
        for m in range(n_micro):
            sl = slice(m * mb, (m + 1) * mb)
            outs.append(self(sample[sl], t[sl] if t.shape[0] == b else t, context[sl],
                             None if added_cond is None else added_cond[sl]))
        return torch.cat(outs, dim=0)

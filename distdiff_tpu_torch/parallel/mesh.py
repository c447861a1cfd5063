"""Device mesh helpers (port of ``distdiff_tpu/parallel/mesh.py``).

One process drives every device of a mesh, as the JAX package's single
controller drives every chip. A ``Mesh`` is an array of ``torch.device``s
with named axes (``data``, ``model``, ``seq``). A ``NamedSharding`` is a
plain function that splits a tensor into its per-device shards along the
dims its ``PartitionSpec`` names, or replicates it. The collectives are
explicit, differentiable tensor operations: ``all_reduce`` sums shards onto
one device, ``all_gather`` concatenates them there, ``ppermute`` is
``.to(next_device)``. Autograd records through them, so the backward ring,
the transpose of an all-reduce (a broadcast) and a gradient's
reduce-scatter come from autograd, as JAX derives them by AD.

A device may appear more than once: ``[cuda:0] * 2`` is a two-way mesh on
one card, as ``--xla_force_host_platform_device_count`` gives JAX virtual
CPU devices. A shard that is the whole tensor on the device it already
lies on is the tensor itself, so replicas on one device share one copy.
``local_devices`` is the one function that lists the devices; the CLI
builds its mesh through it.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"


def local_devices() -> List[torch.device]:
    """This process's devices: every CUDA card, or the CPU alone under
    ``DISTDIFF_PLATFORM=cpu`` (``cli.common.cli_device``'s rule, which
    raises when the card is asked for and there is none)."""
    from distdiff_tpu_torch.cli.common import cli_device

    dev = cli_device()
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def canonical_device(d) -> torch.device:
    """``d`` as a ``torch.device``, a bare ``cuda`` given its index."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:  # "cuda" is the current card
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _device_array(devices: Sequence, shape: Tuple[int, ...]) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [canonical_device(d) for d in devices]
    return arr.reshape(shape)


class Mesh:
    """``devices``: an array (any nesting of lists) of devices, one axis per
    name in ``axis_names``."""

    def __init__(self, devices, axis_names: Sequence[str]):
        flat = np.asarray(devices, dtype=object)
        shape = flat.shape if flat.ndim == len(axis_names) else (len(flat.reshape(-1)),)
        self.devices = _device_array(list(flat.reshape(-1)), shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-d device array for axes {self.axis_names}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def device_list(self) -> List[torch.device]:
        return list(self.devices.reshape(-1))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.device_list()]})"


class PartitionSpec(tuple):
    """One entry per tensor dim: the mesh axis it is split over, or None."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)}"


P = PartitionSpec


class NamedSharding:
    """``sharding(x)`` -> an array of ``mesh.devices``' shape holding each
    device's shard of ``x``: dim d split into ``mesh.shape[spec[d]]`` equal
    parts along that axis, replicated along the axes the spec does not
    name. ``gather`` puts the shards back together."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec = PartitionSpec()):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh.shape}, {self.spec!r})"

    def _slices(self, shape, index) -> Tuple[slice, ...]:
        out = []
        for d, size in enumerate(shape):
            axis = self.spec[d] if d < len(self.spec) else None
            if axis is None:
                out.append(slice(None))
                continue
            n = self.mesh.shape[axis]
            if size % n:
                raise ValueError(f"dim {d} of size {size} does not split over {axis}={n}")
            i = index[self.mesh.axis_names.index(axis)]
            out.append(slice(i * (size // n), (i + 1) * (size // n)))
        return tuple(out)

    def __call__(self, x: torch.Tensor) -> np.ndarray:
        out = np.empty(self.mesh.devices.shape, dtype=object)
        made: Dict[Tuple, torch.Tensor] = {}
        for index, dev in np.ndenumerate(self.mesh.devices):
            sl = self._slices(tuple(x.shape), index)
            key = (tuple((s.start, s.stop) for s in sl), str(dev))
            if key not in made:
                made[key] = x[sl].to(dev)
            out[index] = made[key]
        return out

    def gather(self, shards: np.ndarray, device) -> torch.Tensor:
        """The global tensor on ``device`` from ``shards`` (the first replica
        of each shard)."""
        def rec(arr, names):
            if not names:
                return arr.item() if isinstance(arr, np.ndarray) else arr
            if names[0] not in self.spec:
                return rec(arr[0], names[1:])
            return all_gather([rec(arr[i], names[1:]) for i in range(arr.shape[0])],
                              self.spec.index(names[0]), device)
        return rec(shards, list(self.mesh.axis_names)).to(device)


# ------------------------------------------------------------- collectives

def all_reduce(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The sum of ``parts`` on ``device``. Its transpose under autograd is a
    broadcast of the cotangent to every part's device."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out


def all_gather(parts: Sequence[torch.Tensor], dim: int, device) -> torch.Tensor:
    """``parts`` concatenated along ``dim`` on ``device`` (its transpose: a
    scatter of the cotangent's slices back to the parts' devices); one part
    is passed on as it is."""
    if len(parts) == 1:
        return parts[0].to(device)
    return torch.cat([p.to(device) for p in parts], dim=dim)


def ppermute(x: torch.Tensor, device) -> torch.Tensor:
    """``x`` sent to ``device``: the tensor itself when it is there
    already, else a copy; ``x`` is never changed."""
    return x.to(device)


def split(x: torch.Tensor, n: int, dim: int = 0) -> List[torch.Tensor]:
    """``x`` in ``n`` equal views along ``dim`` (the dim must divide)."""
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split {n} ways")
    return list(torch.chunk(x, n, dim=dim))


def parallel_apply(fn: Callable, inputs: Sequence[tuple],
                   devices: Sequence[torch.device]) -> list:
    """``[fn(*args) for args in inputs]``, the i-th in a thread of its own
    on ``devices[i]`` (the caller's thread when there is one input), with
    the caller's grad mode; an exception of any is raised again here. The
    threads let shards that meet at a rendezvous (the BatchNorm sums of
    ``train.classifier``'s mesh step) run side by side."""
    grad = torch.is_grad_enabled()
    if len(inputs) == 1:
        return [fn(*inputs[0])]
    results: list = [None] * len(inputs)
    errors: list = []

    def work(i):
        try:
            with torch.set_grad_enabled(grad):
                if devices[i].type == "cuda":
                    with torch.cuda.device(devices[i]):
                        results[i] = fn(*inputs[i])
                else:
                    results[i] = fn(*inputs[i])
        except BaseException as e:  # re-raised in the caller
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(inputs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


class BatchNormSync:
    """The rendezvous of one mesh train step's shards at each BatchNorm
    layer (``train.classifier``): every shard's per-channel count, mean and
    biased variance meet on the first device, are combined by Chan's
    formula (and summed over the ranks of a process group) into the global
    batch's mean and variance, and every shard normalises with those, as
    the reference's step normalises over its whole sharded batch. The first
    shard updates the running statistics, once. Each shard runs in its own
    thread (``parallel_apply``) after ``enter(rank)``."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = list(devices)
        self.barrier = threading.Barrier(len(self.devices))
        self.parts: list = [None] * len(self.devices)
        self.result = None
        self._rank = threading.local()

    def enter(self, rank: int) -> None:
        self._rank.value = rank

    def abort(self) -> None:
        self.barrier.abort()

    def _combine(self):
        from distdiff_tpu_torch.parallel.distributed import all_reduce_sum

        home = self.devices[0]
        cnt = all_reduce_sum(torch.tensor(float(sum(c for c, _, _ in self.parts)), device=home))
        mean = all_reduce_sum(sum(c * m.to(home) for c, m, _ in self.parts)) / cnt
        m2 = sum(c * (v.to(home) + (m.to(home) - mean) ** 2) for c, m, v in self.parts)
        return mean, all_reduce_sum(m2) / cnt, cnt

    def __call__(self, bn, x: torch.Tensor) -> torch.Tensor:
        """``bn``'s training forward of this shard's ``x`` on the global
        statistics (flax's running update, momentum ``bn.FLAX_MOMENTUM``)."""
        rank = self._rank.value
        var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
        self.parts[rank] = (x.numel() // x.shape[1], mean, var)
        self.barrier.wait()
        if rank == 0:
            self.result = self._combine()
            g_mean, g_var, _ = self.result
            m = bn.FLAX_MOMENTUM
            with torch.no_grad():
                bn.running_mean.mul_(m).add_(g_mean.detach(), alpha=1 - m)
                bn.running_var.mul_(m).add_(g_var.detach(), alpha=1 - m)
                bn.num_batches_tracked.add_(1)
        self.barrier.wait()
        g_mean, g_var, _ = self.result
        dev = x.device
        scale = torch.rsqrt(g_var.to(dev) + bn.eps) * bn.weight
        shift = bn.bias - g_mean.to(dev) * scale
        return (x * scale[None, :, None, None] + shift[None, :, None, None]).to(x.dtype)


_BN_SYNC: list = [None]


def batch_norm_sync() -> Optional[BatchNormSync]:
    """The rendezvous of the mesh train step running now, or None."""
    return _BN_SYNC[0]


@contextlib.contextmanager
def synced_batch_norm(sync: BatchNormSync):
    """``sync`` is the BatchNorm rendezvous of the calls inside."""
    _BN_SYNC[0] = sync
    try:
        yield sync
    finally:
        _BN_SYNC[0] = None


# ------------------------------------------------------------------ meshes

def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    devices = list(devices) if devices is not None else local_devices()
    return Mesh(devices, (DATA_AXIS,))


def make_expand_mesh(n_model: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """The expansion mesh: the 1-D ``data`` mesh, or (``n_model > 1``) a
    ``data x model`` mesh for tensor-parallel expansion, each model group of
    ``n_model`` devices sharding one UNet's transformer blocks
    (``parallel/tp.py``). ``n_model`` must divide the device count."""
    devices = list(devices) if devices is not None else local_devices()
    if n_model <= 1:
        return Mesh(devices, (DATA_AXIS,))
    from distdiff_tpu_torch.parallel.tp import make_tp_mesh

    if len(devices) % n_model:
        raise ValueError(f"--mesh_model {n_model} does not divide {len(devices)} devices")
    return make_tp_mesh(len(devices) // n_model, n_model, devices=devices)


def data_sharding(mesh: Mesh) -> NamedSharding:
    """The leading batch dim split over the ``data`` axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def data_groups(mesh: Mesh) -> List[List[torch.device]]:
    """One list per index of the ``data`` axis: the devices that work on
    that data shard (its model group on a ``data x model`` mesh, else the
    one device)."""
    if DATA_AXIS not in mesh.shape:
        return [mesh.device_list()]
    k = mesh.axis_names.index(DATA_AXIS)
    grid = np.moveaxis(mesh.devices, k, 0)
    return [list(row) for row in grid.reshape(grid.shape[0], -1)]

"""Multi-process initialisation (port of
``distdiff_tpu/parallel/distributed.py``).

One process with its local devices needs nothing: ``initialize`` is a
no-op there. Several processes (one a host) join one
``torch.distributed`` process group over TCP: ``nccl`` on the cards,
``gloo`` on the CPU. A JAX mesh spans every host's devices; a process's
mesh here holds its own devices only, so across processes the work is
split by rank instead: ``ExpansionDriver`` takes its rank's share of the
manifest, and the classifier's train step all-reduces its gradients and
BatchNorm sums over the ranks (``all_reduce_sum``).
"""

from __future__ import annotations

import logging
from typing import Optional

import torch
import torch.distributed as dist

log = logging.getLogger("distdiff.distributed")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join a multi-process run at ``tcp://{coordinator_address}`` (host:port)
    as rank ``process_id`` of ``num_processes``. A no-op for one process
    with no coordinator."""
    if coordinator_address is None and num_processes in (None, 1):
        log.info("single-process run")
        return
    from distdiff_tpu_torch.parallel.mesh import local_devices

    backend = "nccl" if local_devices()[0].type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    log.info("joined a distributed run: process %d/%d (%s)", process_index(),
             process_count(), backend)


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks (differentiable; ``t`` itself in a
    single-process run)."""
    if process_count() == 1:
        return t
    import torch.distributed.nn.functional as dist_fn

    return dist_fn.all_reduce(t, op=dist.ReduceOp.SUM)

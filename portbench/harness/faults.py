"""Faults planted under the timed path, to show that the comparison sees
them: each breaks what the window produces, and the run must come out not
correct."""

import contextlib

import torch


def half_batch(images, units):
    """Half of the batch left out: its first half's images in both halves."""
    half = images.shape[0] // 2
    return torch.cat([images[:half], images[:half]], dim=0)


def answer_altered(images, units):
    """Every image altered where it is produced."""
    return torch.clamp(images + 0.05, 0.0, 1.0)


HOOKS = {"half_batch": half_batch, "answer_altered": answer_altered}


@contextlib.contextmanager
def state_unchanged():
    """Every denoise step returns its state unchanged."""
    import distdiff_tpu_torch.sampling.sampler as sampler

    orig = sampler.ddim_step
    sampler.ddim_step = lambda sched, out, i, x: (x, x)
    try:
        yield
    finally:
        sampler.ddim_step = orig

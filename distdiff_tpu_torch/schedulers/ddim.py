"""DDIM scheduler (port of ``distdiff_tpu/schedulers/ddim.py``).

The schedule is a table of fp32 constants built once on the host in numpy
(fp64 intermediates); ``ddim_step`` is a function of
``(schedule, model_out, step_index, x)``. Defaults match the SD-1.x
scheduler config (``scaled_linear`` betas, 1000 train steps,
``steps_offset=1``, ``set_alpha_to_one=False``, "leading" spacing).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    # fp32 tables over the full training discretization, shape [T] (numpy).
    alphas_cumprod: np.ndarray
    final_alpha_cumprod: np.float32
    # int64 [num_inference_steps] — descending timesteps actually executed.
    timesteps: np.ndarray
    # fp32 [num_inference_steps] — alpha-bar at each step and its previous.
    step_alphas: np.ndarray
    step_alphas_prev: np.ndarray
    num_train_timesteps: int = 1000
    num_inference_steps: int = 50
    prediction_type: str = "epsilon"
    # alphas_cumprod as a tensor on each device a tensor timestep indexed
    # it on (``alphas_at``), copied there once
    device_tables: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                            compare=False)


def make_schedule(
    num_inference_steps: int = 50,
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "scaled_linear",
    steps_offset: int = 1,
    set_alpha_to_one: bool = False,
    prediction_type: str = "epsilon",
    timestep_spacing: str = "leading",
) -> DDIMSchedule:
    if beta_schedule == "scaled_linear":
        betas = np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                            dtype=np.float64) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps,
                            dtype=np.float64)
    else:
        raise ValueError(f"unknown beta_schedule: {beta_schedule}")

    alphas_cumprod = np.cumprod(1.0 - betas)
    final_alpha_cumprod = 1.0 if set_alpha_to_one else float(alphas_cumprod[0])

    if timestep_spacing == "leading":
        step_ratio = num_train_timesteps // num_inference_steps
        timesteps = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].copy()
        timesteps += steps_offset
    elif timestep_spacing == "trailing":
        step_ratio = num_train_timesteps / num_inference_steps
        timesteps = np.round(np.arange(num_train_timesteps, 0, -step_ratio)) - 1
    else:
        raise ValueError(f"unknown timestep_spacing: {timestep_spacing}")
    timesteps = timesteps.astype(np.int64)

    prev_timesteps = timesteps - num_train_timesteps // num_inference_steps
    step_alphas = alphas_cumprod[timesteps]
    step_alphas_prev = np.where(
        prev_timesteps >= 0,
        alphas_cumprod[np.clip(prev_timesteps, 0, None)],
        final_alpha_cumprod,
    )
    return DDIMSchedule(
        alphas_cumprod=alphas_cumprod.astype(np.float32),
        final_alpha_cumprod=np.float32(final_alpha_cumprod),
        timesteps=timesteps,
        step_alphas=step_alphas.astype(np.float32),
        step_alphas_prev=step_alphas_prev.astype(np.float32),
        num_train_timesteps=num_train_timesteps,
        num_inference_steps=num_inference_steps,
        prediction_type=prediction_type,
    )


def _pred_x0_and_eps(sched, model_out, alpha_t, x):
    sqrt_a = alpha_t.sqrt()
    sqrt_1ma = (1.0 - alpha_t).sqrt()
    if sched.prediction_type == "epsilon":
        eps = model_out
        x0 = (x - sqrt_1ma * eps) / sqrt_a
    elif sched.prediction_type == "v_prediction":
        x0 = sqrt_a * x - sqrt_1ma * model_out
        eps = sqrt_a * model_out + sqrt_1ma * x
    else:
        raise ValueError(f"unknown prediction_type: {sched.prediction_type}")
    return x0, eps


def ddim_step(
    sched: DDIMSchedule,
    model_out: torch.Tensor,
    step_index: int,
    x: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One deterministic (eta=0) DDIM update at plan index ``step_index``.

    Returns ``(prev_sample, pred_original_sample)``; the arithmetic is fp32
    and both results take ``x``'s dtype."""
    orig_dtype = x.dtype
    x32 = x.float()
    out32 = model_out.float()
    alpha_t = torch.tensor(sched.step_alphas[step_index], device=x.device)
    alpha_prev = torch.tensor(sched.step_alphas_prev[step_index], device=x.device)
    x0, eps = _pred_x0_and_eps(sched, out32, alpha_t, x32)
    prev = alpha_prev.sqrt() * x0 + (1.0 - alpha_prev).sqrt() * eps
    return prev.to(orig_dtype), x0.to(orig_dtype)


def alphas_at(sched: DDIMSchedule, timestep, device) -> torch.Tensor:
    """fp32 ``alphas_cumprod[timestep]`` on ``device``. A tensor
    ``timestep`` indexes the schedule's copy of the table on its own device,
    made at the first such call, so that timesteps drawn on the card stay
    there and the table is not copied again."""
    if isinstance(timestep, torch.Tensor):
        table = sched.device_tables.get(timestep.device)
        if table is None:
            table = torch.as_tensor(sched.alphas_cumprod, device=timestep.device)
            sched.device_tables[timestep.device] = table
        return table[timestep].to(device)
    return torch.as_tensor(sched.alphas_cumprod[np.asarray(timestep)], device=device)


def add_noise(
    sched: DDIMSchedule,
    x0: torch.Tensor,
    noise: torch.Tensor,
    timestep,
) -> torch.Tensor:
    """Forward-process noising ``x_t = sqrt(a_t) x0 + sqrt(1-a_t) eps``.
    ``timestep`` (an int, a per-sample sequence, or an int64 tensor on
    ``x0``'s device) indexes the training discretization."""
    a = alphas_at(sched, timestep, x0.device)
    while a.ndim < x0.ndim:
        a = a[..., None]
    out = a.sqrt() * x0.float() + (1.0 - a).sqrt() * noise.float()
    return out.to(x0.dtype)


def img2img_start_index(sched: DDIMSchedule, strength: float) -> int:
    """Index into the step plan where img2img begins (50 steps at strength
    0.5: steps 25..49 execute)."""
    start = int((1.0 - strength) * sched.num_inference_steps)
    return min(max(start, 0), sched.num_inference_steps - 1)


def guidance_window(
    sched: DDIMSchedule, guidance_step: int, guidance_period: int
) -> Tuple[int, int]:
    """[start, end) plan indices of the guided steps; ``guidance_step``
    counts from the END of the plan (50 steps, 20, 2 -> (30, 32))."""
    n = sched.num_inference_steps
    start = n - guidance_step
    end = start + guidance_period
    if not (0 <= start < n and start < end <= n):
        raise ValueError(
            f"guidance window [{start},{end}) out of range for {n} steps")
    return start, end

"""DPM-Solver++(2M) (port of ``distdiff_tpu/schedulers/dpm.py``): the
data-prediction multistep solver of order 2 (Lu et al. 2022), diffusers'
``DPMSolverMultistepScheduler(algorithm_type="dpmsolver++", solver_order=2)``.

``DPMSchedule`` extends ``DDIMSchedule`` with the solver's tables, so every
DDIM consumer (``ddim_step``, ``add_noise``, ``img2img_start_index``, the
guidance rollout) takes it unchanged: the guidance window advances with the
DDIM update, and the solver's x0 history starts empty on each span (after
guidance rewrote the latents, the history no longer describes them). The
tables are built in float64 and stored in fp32; a step's scalars are fp32
numpy arithmetic on the host, so no step copies a scalar to the device.
The last step targets the chain's smallest noise level, as the DDIM tables
do (``set_alpha_to_one=False``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from distdiff_tpu_torch.schedulers.ddim import DDIMSchedule, make_schedule


@dataclasses.dataclass(frozen=True)
class DPMSchedule(DDIMSchedule):
    """DDIM's tables plus, all fp32 ``[num_inference_steps]``: alpha_t =
    sqrt(abar), sigma_t = sqrt(1 - abar) and lambda_t = log(alpha / sigma)
    at each executed step (``step_*``) and at its target (``prev_*``)."""

    step_alpha_sqrt: Optional[np.ndarray] = None
    step_sigma: Optional[np.ndarray] = None
    step_lambda: Optional[np.ndarray] = None
    prev_alpha_sqrt: Optional[np.ndarray] = None
    prev_sigma: Optional[np.ndarray] = None
    prev_lambda: Optional[np.ndarray] = None
    # the first-order update on the last step of plans under 15 steps
    # (diffusers' lower_order_final)
    lower_order_final: bool = True


def make_dpm_schedule(num_inference_steps: int = 50, lower_order_final: bool = True,
                      **kwargs) -> DPMSchedule:
    """The solver's tables on the DDIM plan of ``make_schedule`` (every
    knob of it accepted), so strength indexing and the guidance window land
    on the same timesteps."""
    base = make_schedule(num_inference_steps, **kwargs)

    def tables(a):
        a = np.asarray(a, np.float64)
        alpha, sigma = np.sqrt(a), np.sqrt(1.0 - a)
        lam = np.log(alpha) - np.log(sigma)
        return tuple(t.astype(np.float32) for t in (alpha, sigma, lam))

    sa, ss, sl = tables(base.step_alphas)
    pa, ps, pl = tables(base.step_alphas_prev)
    return DPMSchedule(
        **{f.name: getattr(base, f.name) for f in dataclasses.fields(DDIMSchedule) if f.init},
        step_alpha_sqrt=sa, step_sigma=ss, step_lambda=sl,
        prev_alpha_sqrt=pa, prev_sigma=ps, prev_lambda=pl,
        lower_order_final=lower_order_final,
    )


def _pred_x0(sched: DPMSchedule, out, alpha, sigma, x):
    """The data prediction from the model output (the "++" form)."""
    if sched.prediction_type == "epsilon":
        return (x - sigma * out) / alpha
    if sched.prediction_type == "v_prediction":
        return alpha * x - sigma * out
    raise ValueError(f"unknown prediction_type: {sched.prediction_type}")


def dpm_step(sched: DPMSchedule, model_out: torch.Tensor, step_index: int, x: torch.Tensor,
             prev_x0: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """One DPM-Solver++(2M) update at plan index ``step_index``.

    ``prev_x0`` is the previous step's data prediction, or None on a span's
    first step (then the update is first order). Returns ``(x_next, x0)``:
    the next latents in ``x``'s dtype and this step's fp32 data prediction,
    the next call's ``prev_x0``."""
    i, f32 = step_index, np.float32
    alpha_s, sigma_s, lam_s = (f32(t[i]) for t in (sched.step_alpha_sqrt, sched.step_sigma,
                                                   sched.step_lambda))
    alpha_t, sigma_t, lam_t = (f32(t[i]) for t in (sched.prev_alpha_sqrt, sched.prev_sigma,
                                                   sched.prev_lambda))
    x32 = x.float()
    x0 = _pred_x0(sched, model_out.float(), float(alpha_s), float(sigma_s), x32)
    h = f32(lam_t - lam_s)
    n = sched.num_inference_steps
    second = prev_x0 is not None and not (sched.lower_order_final and n < 15 and i >= n - 1)
    if second:
        # the previous step's h: its target is this step's source
        h_last = f32(lam_s - f32(sched.step_lambda[max(i - 1, 0)]))
        half_inv_r = f32(f32(1.0) / (f32(2.0) * f32(h_last / h)))
        d = float(f32(1.0) + half_inv_r) * x0 - float(half_inv_r) * prev_x0.float()
    else:
        d = x0
    x_next = float(f32(sigma_t / sigma_s)) * x32 - float(f32(alpha_t * np.expm1(-h))) * d
    return x_next.to(x.dtype), x0


def denoise_range_dpm(sched: DPMSchedule, eps_fn: Callable, latents, cond, uncond,
                      start: int, stop: int) -> torch.Tensor:
    """Plan steps [start, stop), the x0 history empty at ``start``: each
    span between guidance splices is solved on its own."""
    x, prev_x0 = latents, None
    for i in range(start, stop):
        out = eps_fn(x, int(sched.timesteps[i]), cond, uncond)
        x, prev_x0 = dpm_step(sched, out, i, x, prev_x0)
    return x

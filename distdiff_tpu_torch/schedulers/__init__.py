from distdiff_tpu_torch.schedulers.ddim import (
    DDIMSchedule,
    add_noise,
    ddim_step,
    guidance_window,
    img2img_start_index,
    make_schedule,
)
from distdiff_tpu_torch.schedulers.dpm import (
    DPMSchedule,
    denoise_range_dpm,
    dpm_step,
    make_dpm_schedule,
)


def build_schedule(scheduler: str = "ddim", num_inference_steps: int = 50, **kwargs):
    """The schedule of ``scheduler``: ``"ddim"`` (the reference's) or
    ``"dpmpp"`` (DPM-Solver++(2M); also ``"dpmsolver++"``, ``"dpm++2m"``).
    Both share the beta/timestep plan, so strength indexing and the
    guidance window do not depend on the solver."""
    if scheduler == "ddim":
        return make_schedule(num_inference_steps, **kwargs)
    if scheduler in ("dpmpp", "dpmsolver++", "dpm++2m"):
        return make_dpm_schedule(num_inference_steps, **kwargs)
    raise ValueError(f"unknown scheduler: {scheduler!r} (expected 'ddim' or 'dpmpp')")


__all__ = [
    "DDIMSchedule",
    "DPMSchedule",
    "add_noise",
    "build_schedule",
    "ddim_step",
    "denoise_range_dpm",
    "dpm_step",
    "guidance_window",
    "img2img_start_index",
    "make_dpm_schedule",
    "make_schedule",
]

from distdiff_tpu_torch.schedulers.ddim import (
    DDIMSchedule,
    add_noise,
    ddim_step,
    guidance_window,
    img2img_start_index,
    make_schedule,
)

__all__ = [
    "DDIMSchedule",
    "add_noise",
    "ddim_step",
    "guidance_window",
    "img2img_start_index",
    "make_schedule",
]

from distdiff_tpu_torch.models.unet import UNet2DConditionModel
from distdiff_tpu_torch.models.vae import AutoencoderKL

__all__ = ["AutoencoderKL", "UNet2DConditionModel"]

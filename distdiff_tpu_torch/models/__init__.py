from distdiff_tpu_torch.models.text_encoder import CLIPTextEncoder
from distdiff_tpu_torch.models.tokenizer import (
    CLIPTokenizer,
    HashTokenizer,
    discover_bpe,
    load_tokenizer,
)
from distdiff_tpu_torch.models.unet import UNet2DConditionModel
from distdiff_tpu_torch.models.vae import AutoencoderKL

__all__ = ["AutoencoderKL", "CLIPTextEncoder", "CLIPTokenizer", "HashTokenizer",
           "UNet2DConditionModel", "discover_bpe", "load_tokenizer"]

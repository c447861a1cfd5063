"""Model / pipeline configuration dataclasses (port of
``distdiff_tpu/config.py``).

Only the SD-1.x and tiny geometries of the guided expansion path are
carried over; dtypes are ``torch.dtype``s.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """UNet2DCondition architecture (SD-1.x geometry by default)."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # Per down-block: does it carry cross-attention transformers?
    cross_attention: Tuple[bool, ...] = (True, True, True, False)
    transformer_depth: Any = 1
    num_attention_heads: Any = 8
    cross_attention_dim: int = 768
    time_embed_dim_mult: int = 4
    dtype: torch.dtype = torch.bfloat16

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * self.time_embed_dim_mult

    def depth_at(self, block: int) -> int:
        d = self.transformer_depth
        return d[block] if isinstance(d, (tuple, list)) else d

    def heads_at(self, block: int) -> int:
        h = self.num_attention_heads
        return h[block] if isinstance(h, (tuple, list)) else h

    @staticmethod
    def sd15() -> "UNetConfig":
        return UNetConfig()

    @staticmethod
    def tiny() -> "UNetConfig":
        return UNetConfig(
            block_out_channels=(32, 64),
            layers_per_block=1,
            cross_attention=(True, False),
            num_attention_heads=2,
            cross_attention_dim=32,
            dtype=torch.float32,
        )


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL architecture (SD-1.x geometry by default)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = 0.18215
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def sd15() -> "VAEConfig":
        return VAEConfig()

    @staticmethod
    def tiny() -> "VAEConfig":
        return VAEConfig(
            block_out_channels=(16, 32),
            layers_per_block=1,
            dtype=torch.float32,
        )


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Everything needed to assemble the expansion pipeline."""

    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig.sd15)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig.sd15)
    sample_size: int = 512  # pixel resolution
    num_inference_steps: int = 50
    prediction_type: str = "epsilon"
    # text context length (CLIP's 77 tokens for SD-1.x)
    max_text_length: int = 77

    @property
    def vae_scale_factor(self) -> int:
        return 2 ** (len(self.vae.block_out_channels) - 1)

    @property
    def latent_size(self) -> int:
        return self.sample_size // self.vae_scale_factor

    @staticmethod
    def sd15() -> "PipelineConfig":
        return PipelineConfig()

    @staticmethod
    def tiny(sample_size: int = 32) -> "PipelineConfig":
        return PipelineConfig(
            unet=UNetConfig.tiny(),
            vae=VAEConfig.tiny(),
            sample_size=sample_size,
            num_inference_steps=10,
            max_text_length=16,
        )


@dataclasses.dataclass(frozen=True)
class GuidanceConfig:
    """DistDiff guidance hyperparameters (reference defaults)."""

    guidance_type: str = "transform_guidance"  # or "direct_guidance", "none"
    guidance_step: int = 20        # counted from the END of the step plan
    guidance_period: int = 2
    rho: float = 10.0              # guidance SGD learning rate
    constraint_value: float = 0.2  # l-inf ball radius around the latents
    gs: float = 1.0                # global-prototype energy weight
    ls: float = 1.0                # local-prototype energy weight
    K: int = 3                     # local prototypes per class
    optimize_targets: Sequence[str] = ("global_prototype", "local_prototype")
    # transform_guidance does not L2-normalise features, direct_guidance does
    normalize_features: Optional[bool] = None
    step_in_plan: bool = False
    guide_input_size: int = 224
    # Only "step" (a checkpoint around each rollout step) is ported.
    rollout_remat: str = "step"

    def wants_global(self) -> bool:
        return "global_prototype" in self.optimize_targets

    def wants_local(self) -> bool:
        return "local_prototype" in self.optimize_targets

"""Model / pipeline configuration dataclasses (port of
``distdiff_tpu/config.py``).

The SD-1.x, SD-2.1, SDXL-base and tiny geometries of the guided expansion
path (the UNet, the VAE, the CLIP or OpenCLIP text encoders) are carried
over, with the JAX package's switches; dtypes are ``torch.dtype``s.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """UNet2DCondition architecture (SD-1.x geometry by default; SD-2.1 via
    :meth:`sd21`, SDXL-base via :meth:`sdxl_base`)."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # Per down-block: does it carry cross-attention transformers?
    cross_attention: Tuple[bool, ...] = (True, True, True, False)
    # int (uniform) or per-block tuple (SDXL: (0, 2, 10))
    transformer_depth: Any = 1
    # int (uniform) or per-block tuple (SDXL: heads 64 wide, (5, 10, 20))
    num_attention_heads: Any = 8
    cross_attention_dim: int = 768
    time_embed_dim_mult: int = 4
    # SDXL's additive conditioning: the width of [pooled text | fourier
    # time ids] fed through ``add_embedding`` into the time embedding
    # (2816 = 1280 + 6 * 256 for SDXL-base); None: no such input
    addition_embed_dim: Optional[int] = None
    # diffusers' use_linear_projection (SD-2.x): the transformers' proj_in
    # and proj_out are linear [C, C] layers on the tokens instead of 1x1
    # convolutions [C, C, 1, 1]; the same function either way.
    linear_projection: bool = False
    # Checkpoint each ResnetBlock2D and Transformer2DModel in the backward
    # (the JAX package's nn.remat). Taken only while autograd records.
    remat: bool = True
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
    def sd21() -> "UNetConfig":
        """SD-2.1: SD-1.x topology with heads 64 wide everywhere (5/10/20/20
        a block), the 1024-wide OpenCLIP-H context and linear projections
        (865,910,724 parameters)."""
        return UNetConfig(
            num_attention_heads=(5, 10, 20, 20),
            cross_attention_dim=1024,
            linear_projection=True,
        )

    @staticmethod
    def sdxl_base() -> "UNetConfig":
        """SDXL-base: three levels (320/640/1280), no attention at the top
        level, transformer depths 0/2/10, heads 64 wide, the 2048-wide
        dual-tower context, linear projections and the 2816-wide additive
        conditioning (2,567,463,684 parameters)."""
        return UNetConfig(
            block_out_channels=(320, 640, 1280),
            cross_attention=(False, True, True),
            transformer_depth=(0, 2, 10),
            num_attention_heads=(5, 10, 20),
            cross_attention_dim=2048,
            addition_embed_dim=2816,
            linear_projection=True,
        )

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
    # Checkpoint each decoder ResnetBlock2D in the backward (the JAX
    # package's nn.remat); taken only while autograd records.
    remat: bool = True
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def sd15() -> "VAEConfig":
        return VAEConfig()

    @staticmethod
    def sdxl() -> "VAEConfig":
        """SDXL's retrained VAE: SD-1.x's architecture, latent scale
        0.13025."""
        return VAEConfig(scaling_factor=0.13025)

    @staticmethod
    def tiny() -> "VAEConfig":
        return VAEConfig(
            block_out_channels=(16, 32),
            layers_per_block=1,
            dtype=torch.float32,
        )


@dataclasses.dataclass(frozen=True)
class TextEncoderConfig:
    """CLIP text transformer (SD-1.x uses CLIP ViT-L/14's text tower)."""

    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    max_length: int = 77
    # CLIP uses quick_gelu; newer OpenCLIP text towers use gelu.
    activation: str = "quick_gelu"
    # when set, a bias-free ``text_projection`` maps the pooled end-of-text
    # hidden state to this width (SDXL's text_encoder_2, zero-shot heads)
    embed_dim: Optional[int] = None
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def sd15() -> "TextEncoderConfig":
        return TextEncoderConfig()

    @staticmethod
    def sd21() -> "TextEncoderConfig":
        """SD-2's text encoder: the OpenCLIP ViT-H/14 text tower cut to 23
        layers, width 1024, 16 heads, gelu (340,387,840 parameters)."""
        return TextEncoderConfig(
            hidden_size=1024, num_layers=23, num_heads=16, activation="gelu",
        )

    @staticmethod
    def sdxl_big() -> "TextEncoderConfig":
        """SDXL's text_encoder_2: the OpenCLIP-bigG text tower, width 1280,
        32 layers, 20 heads, gelu, projected pooled output (694,659,840
        parameters)."""
        return TextEncoderConfig(
            hidden_size=1280, num_layers=32, num_heads=20, activation="gelu",
            embed_dim=1280,
        )

    @staticmethod
    def tiny() -> "TextEncoderConfig":
        return TextEncoderConfig(
            vocab_size=1000, hidden_size=32, num_layers=2, num_heads=2,
            max_length=16, dtype=torch.float32,
        )


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Everything needed to assemble the expansion pipeline."""

    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig.sd15)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig.sd15)
    text_encoder: TextEncoderConfig = dataclasses.field(
        default_factory=TextEncoderConfig.sd15)
    # SDXL's second text tower (OpenCLIP-bigG); None for SD-1.x and SD-2.x.
    # When set, the conditioning is the {"ctx", "add"} dict
    # (sampling/conditioning.py)
    text_encoder_2: Optional[TextEncoderConfig] = None
    sample_size: int = 512  # pixel resolution
    num_inference_steps: int = 50
    # the UNet's output: "epsilon" (SD-1.x) or "v_prediction" (SD-2.1 768-v)
    prediction_type: str = "epsilon"
    # the solver: "ddim" (the reference's) or "dpmpp" (DPM-Solver++(2M))
    scheduler: str = "ddim"
    # DeepCache (sampling/deepcache.py), opt-in and approximate: a full UNet
    # step every cache_interval steps, shallow steps (down levels <=
    # cache_branch refreshed, the deep feature cached) in between. DDIM only.
    deep_cache: bool = False
    cache_interval: int = 3
    cache_branch: int = 0
    # int8 w8a8 UNet denoise spans (ops/quant.py), opt-in and approximate;
    # the guidance steps and the VAE stay exact
    int8: bool = False
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
    def sdxl_base(sample_size: int = 1024) -> "PipelineConfig":
        """SDXL-base: the three-level UNet with additive conditioning, the
        SDXL VAE (SD-1.x geometry, scale 0.13025), CLIP-L and OpenCLIP-bigG
        text towers."""
        return PipelineConfig(
            unet=UNetConfig.sdxl_base(),
            vae=VAEConfig.sdxl(),
            text_encoder=TextEncoderConfig.sd15(),
            text_encoder_2=TextEncoderConfig.sdxl_big(),
            sample_size=sample_size,
        )

    @staticmethod
    def sd21(sample_size: int = 768,
             prediction_type: str = "v_prediction") -> "PipelineConfig":
        """SD-2.1, 768-v by default; ``sample_size=512,
        prediction_type="epsilon"`` gives the 512-base variant. The VAE is
        SD-1.x's."""
        return PipelineConfig(
            unet=UNetConfig.sd21(),
            vae=VAEConfig.sd15(),
            text_encoder=TextEncoderConfig.sd21(),
            sample_size=sample_size,
            prediction_type=prediction_type,
        )

    @staticmethod
    def sdxl_tiny(sample_size: int = 32) -> "PipelineConfig":
        """SDXL in toy widths: per-block depths, heads and the level with no
        attention, both text towers, the additive conditioning, the linear
        projections; fp32, no inner checkpoints."""
        return PipelineConfig(
            unet=UNetConfig(
                block_out_channels=(16, 32, 64),
                layers_per_block=1,
                cross_attention=(False, True, True),
                transformer_depth=(0, 1, 2),
                num_attention_heads=(2, 2, 4),
                cross_attention_dim=48,
                addition_embed_dim=16 + 6 * 8,
                linear_projection=True,
                dtype=torch.float32,
                remat=False,
            ),
            vae=VAEConfig.tiny(),
            text_encoder=TextEncoderConfig(
                vocab_size=1000, hidden_size=16, num_layers=2, num_heads=2,
                max_length=16, dtype=torch.float32,
            ),
            text_encoder_2=TextEncoderConfig(
                vocab_size=1000, hidden_size=32, num_layers=2, num_heads=2,
                max_length=16, embed_dim=16, activation="gelu", dtype=torch.float32,
            ),
            sample_size=sample_size,
            num_inference_steps=10,
            max_text_length=16,
        )

    @staticmethod
    def tiny(sample_size: int = 32) -> "PipelineConfig":
        return PipelineConfig(
            unet=UNetConfig.tiny(),
            vae=VAEConfig.tiny(),
            text_encoder=TextEncoderConfig.tiny(),
            sample_size=sample_size,
            num_inference_steps=10,
            max_text_length=16,
        )


ROLLOUT_REMAT_MODES = ("step", "decode", "block", "step_nru", "step_nr", "tail",
                       "decode_nr", "tail_decode_nr")


@dataclasses.dataclass(frozen=True)
class GuidanceConfig:
    """DistDiff guidance hyperparameters (reference defaults). One default
    departs from the JAX package's: ``rollout_remat`` is ``"step_nr"``
    (the JAX package's is ``"step"``), the placement the port's main path
    ran and was measured with before the other modes were ported; every
    mode gives the same values."""

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
    # Where the guidance backward recomputes instead of storing ("outer":
    # a checkpoint around each rollout step, UNet step + decode + guide;
    # "inner": the UNet's and the VAE decoder's per-block checkpoints):
    #   "step"           outer, inner in the UNet and the decoder
    #   "decode"         no outer, inner in both, the decode + guide leg
    #                    checkpointed
    #   "block"          inner in both only
    #   "step_nru"       outer, inner in the decoder only
    #   "step_nr"        outer, no inner
    #   "tail"           "step", but the last rollout step has no outer
    #   "decode_nr"      outer, inner in the UNet only
    #   "tail_decode_nr" "tail" with the decoder's inner off
    # Every mode gives the same values; only memory and recompute differ.
    rollout_remat: str = "step_nr"

    def __post_init__(self):
        if self.rollout_remat not in ROLLOUT_REMAT_MODES:
            raise ValueError(f"unknown rollout_remat {self.rollout_remat!r}; "
                             f"one of {', '.join(ROLLOUT_REMAT_MODES)}")

    def wants_global(self) -> bool:
        return "global_prototype" in self.optimize_targets

    def wants_local(self) -> bool:
        return "local_prototype" in self.optimize_targets

from distdiff_tpu_torch.sampling.pipeline import (
    ExpansionPipeline,
    SplitExpand,
    cast_params_bf16,
)
from distdiff_tpu_torch.sampling.sampler import SamplerConfig

__all__ = ["ExpansionPipeline", "SamplerConfig", "SplitExpand", "cast_params_bf16"]

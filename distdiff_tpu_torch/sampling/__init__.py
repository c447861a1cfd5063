from distdiff_tpu_torch.sampling.pipeline import ExpansionPipeline, cast_params_bf16
from distdiff_tpu_torch.sampling.sampler import SamplerConfig

__all__ = ["ExpansionPipeline", "SamplerConfig", "cast_params_bf16"]

from distdiff_tpu_torch.guidance.energy import hierarchical_energy_per_sample
from distdiff_tpu_torch.guidance.optimize import (
    GuidanceContext,
    direct_guidance,
    transform_guidance,
)

__all__ = [
    "GuidanceContext",
    "direct_guidance",
    "hierarchical_energy_per_sample",
    "transform_guidance",
]

from distdiff_tpu_torch.guidance.energy import (
    global_energy,
    hierarchical_energy,
    hierarchical_energy_per_sample,
    local_energy,
)
from distdiff_tpu_torch.guidance.optimize import (
    GuidanceContext,
    direct_guidance,
    transform_guidance,
)

__all__ = [
    "GuidanceContext",
    "direct_guidance",
    "global_energy",
    "hierarchical_energy",
    "hierarchical_energy_per_sample",
    "local_energy",
    "transform_guidance",
]

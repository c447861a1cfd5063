from distdiff_tpu_torch.prototypes.cluster import agglomerative_average
from distdiff_tpu_torch.prototypes.extract import (
    build_prototypes,
    extract_features,
    load_prototypes,
    normalize_prototypes,
    save_prototypes,
)

__all__ = ["agglomerative_average", "build_prototypes", "extract_features",
           "load_prototypes", "normalize_prototypes", "save_prototypes"]

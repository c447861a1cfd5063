from distdiff_tpu_torch.parallel.driver import ExpansionDriver, read_png, save_png
from distdiff_tpu_torch.parallel.manifest import (
    WorkUnit,
    build_manifest,
    chunk_units,
    output_path,
    split_range,
)

__all__ = ["ExpansionDriver", "WorkUnit", "build_manifest", "chunk_units", "output_path",
           "read_png", "save_png", "split_range"]

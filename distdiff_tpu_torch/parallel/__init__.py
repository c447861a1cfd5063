from distdiff_tpu_torch.parallel.driver import ExpansionDriver, read_png, save_png
from distdiff_tpu_torch.parallel.fsdp import (
    fsdp_sharding,
    make_fsdp_train_step,
    shard_state,
)
from distdiff_tpu_torch.parallel.manifest import (
    WorkUnit,
    build_manifest,
    chunk_units,
    output_path,
    split_range,
)
from distdiff_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    data_sharding,
    make_mesh,
    replicated,
)
from distdiff_tpu_torch.parallel.pp import (
    PipelinedUNet,
    plan_boundaries,
    split_unet_params,
)

__all__ = [
    "ExpansionDriver",
    "read_png",
    "save_png",
    "WorkUnit",
    "build_manifest",
    "chunk_units",
    "output_path",
    "split_range",
    "DATA_AXIS",
    "fsdp_sharding",
    "make_fsdp_train_step",
    "shard_state",
    "make_mesh",
    "data_sharding",
    "replicated",
    "PipelinedUNet",
    "plan_boundaries",
    "split_unet_params",
]

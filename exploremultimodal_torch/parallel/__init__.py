"""Training and serving on more than one process (counterpart of
`exploremultimodal_tpu/parallel`): the process group and mesh, the
collectives of the objectives, and the presets' wrap of the task and
optimizer."""

from exploremultimodal_torch.parallel.collectives import (
    DataAxis,
    TensorAxis,
    all_gather_with_grad,
    concat_all_gather,
    copy_to_tensor_region,
    global_sum,
    reduce_from_tensor_region,
)
from exploremultimodal_torch.parallel.mesh import (
    DATA_AXIS,
    FSDP_AXIS,
    TENSOR_AXIS,
    Mesh,
    Runtime,
    create_mesh,
    initialize_runtime,
    mesh_shape,
)

__all__ = [
    "DATA_AXIS", "FSDP_AXIS", "TENSOR_AXIS", "DataAxis", "Mesh", "Runtime", "TensorAxis",
    "all_gather_with_grad", "concat_all_gather", "copy_to_tensor_region", "create_mesh",
    "global_sum", "initialize_runtime", "mesh_shape", "reduce_from_tensor_region",
]

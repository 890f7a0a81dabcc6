"""Training and serving on more than one process (counterpart of
`exploremultimodal_tpu/parallel`): the process group and mesh, the
collectives of the objectives, and the presets' wrap of the task and
optimizer."""

from exploremultimodal_torch.parallel.collectives import (
    DataAxis,
    all_gather_with_grad,
    concat_all_gather,
    global_sum,
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
    "DATA_AXIS", "FSDP_AXIS", "TENSOR_AXIS", "DataAxis", "Mesh", "Runtime",
    "all_gather_with_grad", "concat_all_gather", "create_mesh", "global_sum",
    "initialize_runtime", "mesh_shape",
]

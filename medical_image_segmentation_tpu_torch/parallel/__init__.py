"""Multi-process training: process layout, meshes, collectives
(``parallel/mesh.py``) and the tensor-parallel heads (``parallel/tp.py``).
Port of the JAX package's ``parallel/__init__.py``."""

from medical_image_segmentation_tpu_torch.parallel.mesh import (
    Mesh,
    Process,
    data_rows,
    initialize_distributed,
    make_mesh,
    replicate,
)
from medical_image_segmentation_tpu_torch.parallel.tp import check_model_parallel, shard_dim

__all__ = [
    "Mesh",
    "Process",
    "data_rows",
    "initialize_distributed",
    "make_mesh",
    "replicate",
    "check_model_parallel",
    "shard_dim",
]

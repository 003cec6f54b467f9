"""Multi-process training: process layout, meshes, collectives
(``parallel/mesh.py``), the tensor-parallel heads (``parallel/tp.py``) and
the depth-sharding halo exchange (``parallel/spatial.py``); one process on
every local device (``parallel/replicas.py``). Port of the JAX package's
``parallel/__init__.py``."""

from medical_image_segmentation_tpu_torch.parallel.mesh import (
    Mesh,
    Process,
    data_rows,
    depth_slab,
    initialize_distributed,
    make_mesh,
    replicate,
)
from medical_image_segmentation_tpu_torch.parallel.replicas import Replicas, local_devices
from medical_image_segmentation_tpu_torch.parallel.spatial import halo_exchange
from medical_image_segmentation_tpu_torch.parallel.tp import check_model_parallel, shard_dim

__all__ = [
    "Mesh",
    "Process",
    "data_rows",
    "depth_slab",
    "initialize_distributed",
    "make_mesh",
    "replicate",
    "check_model_parallel",
    "shard_dim",
    "halo_exchange",
    "Replicas",
    "local_devices",
]

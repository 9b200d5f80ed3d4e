"""Device meshes, the sharding rule and multi-process start."""

from .distributed import (initialize_multihost, is_primary,
                          local_batch_slice)
from .mesh import (DeviceMesh, batch_spec, create_mesh, infer_param_spec,
                   replicate, serving_mesh, shard_batch)

__all__ = ["DeviceMesh", "create_mesh", "batch_spec", "serving_mesh",
           "infer_param_spec", "replicate", "shard_batch",
           "initialize_multihost", "is_primary", "local_batch_slice"]

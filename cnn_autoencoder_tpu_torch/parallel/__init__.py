"""Device meshes, the sharding rule, model-axis shards and multi-process
start."""

from .distributed import (initialize_multihost, is_primary,
                          local_batch_slice, mesh_groups)
from .mesh import (DeviceMesh, batch_spec, create_mesh, data_devices,
                   gather_state, infer_param_spec, replicate, serving_mesh,
                   shard_batch, shard_model, shard_state)

__all__ = ["DeviceMesh", "create_mesh", "data_devices", "batch_spec",
           "serving_mesh", "infer_param_spec", "replicate", "shard_batch",
           "shard_state", "gather_state", "shard_model",
           "initialize_multihost", "is_primary", "local_batch_slice",
           "mesh_groups"]

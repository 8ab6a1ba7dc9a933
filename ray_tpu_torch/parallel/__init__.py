"""Parallelism layer of the port: device meshes with the canonical axis
names (mesh.py) and the logical-axis rules with the tensor-parallel split
of params (sharding.py). The pipeline and the memory planner are not
ported yet (ROADMAP Queue 1 item 7), nor meshes for training (item 4)."""

from .mesh import (AXES, EP_AXES, Mesh, MeshSpec, build_mesh,
                   host_local_mesh, mesh_info, single_device_mesh)
from .sharding import (LogicalAxisRules, PartitionSpec, replicated,
                       shard_params, tree_specs)

__all__ = ["AXES", "EP_AXES", "Mesh", "MeshSpec", "build_mesh",
           "host_local_mesh", "mesh_info", "single_device_mesh",
           "LogicalAxisRules", "PartitionSpec", "replicated",
           "shard_params", "tree_specs"]

"""Parallelism layer of the port: device meshes with the canonical axis
names (mesh.py), the logical-axis rules with the explicit split of params
and batches over a mesh's positions (sharding.py), and the per-position
memory plan of a sharded train step (planner.py). The pipeline is not
ported yet (ROADMAP Queue 1 item 7)."""

from .mesh import (AXES, EP_AXES, Mesh, MeshSpec, build_mesh,
                   host_local_mesh, mesh_info, single_device_mesh)
from .planner import MemoryPlan, plan_train_memory
from .sharding import (LogicalAxisRules, PartitionSpec, gather_params,
                       replicated, shard_batch, shard_params, tree_specs)

__all__ = ["AXES", "EP_AXES", "Mesh", "MeshSpec", "build_mesh",
           "host_local_mesh", "mesh_info", "single_device_mesh",
           "MemoryPlan", "plan_train_memory",
           "LogicalAxisRules", "PartitionSpec", "gather_params",
           "replicated", "shard_batch", "shard_params", "tree_specs"]

"""Parallelism layer of the port: device meshes with the canonical axis
names (mesh.py), the logical-axis rules with the explicit split of params
and batches over a mesh's positions (sharding.py), the GPipe schedule over
the pp axis (pipeline.py), and the per-position memory plan of a sharded
train step (planner.py)."""

from .mesh import (AXES, EP_AXES, Mesh, MeshSpec, build_mesh,
                   host_local_mesh, mesh_info, single_device_mesh)
from .pipeline import merge_stages, pipeline_spmd, split_stages
from .planner import MemoryPlan, plan_7b_north_star, plan_train_memory
from .sharding import (LogicalAxisRules, PartitionSpec, gather_params,
                       replicated, shard_batch, shard_params, tree_specs)

__all__ = ["AXES", "EP_AXES", "Mesh", "MeshSpec", "build_mesh",
           "host_local_mesh", "mesh_info", "single_device_mesh",
           "merge_stages", "pipeline_spmd", "split_stages",
           "MemoryPlan", "plan_7b_north_star", "plan_train_memory",
           "LogicalAxisRules", "PartitionSpec", "gather_params",
           "replicated", "shard_batch", "shard_params", "tree_specs"]

"""Parallelism layer of the port: device meshes with the canonical axis
names (mesh.py). Shardings, the pipeline and the memory planner are not
ported yet (ROADMAP Queue 1 items 4 and 7)."""

from .mesh import (AXES, EP_AXES, Mesh, MeshSpec, build_mesh,
                   host_local_mesh, mesh_info, single_device_mesh)

__all__ = ["AXES", "EP_AXES", "Mesh", "MeshSpec", "build_mesh",
           "host_local_mesh", "mesh_info", "single_device_mesh"]

"""Mesh entry point: the meshes over the ``torch.distributed`` world
(``distributed/mesh.py``): the join mesh, and the model zoo's production
mesh with its logical axis rules."""

from __future__ import annotations

from repro_torch.distributed.mesh import (AxisEnv, JoinMesh, Spec, axis_size,
                                          batch_spec, init_from_env,
                                          l_shard_axes, make_host_mesh,
                                          make_join_mesh, make_mesh,
                                          make_production_mesh, shard_leaf,
                                          unshard_leaf, world_size)

__all__ = ["AxisEnv", "JoinMesh", "Spec", "axis_size", "batch_spec",
           "init_from_env", "l_shard_axes", "make_host_mesh",
           "make_join_mesh", "make_mesh", "make_production_mesh",
           "shard_leaf", "unshard_leaf", "world_size"]

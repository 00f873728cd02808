"""Mesh entry point: the join mesh over the ``torch.distributed`` world
(``distributed/mesh.py``).  The model zoo's production mesh and logical
axis rules wait for the zoo's port."""

from __future__ import annotations

from repro_torch.distributed.mesh import (JoinMesh, init_from_env,
                                          l_shard_axes, make_host_mesh,
                                          make_join_mesh, world_size)

__all__ = ["JoinMesh", "init_from_env", "l_shard_axes", "make_host_mesh",
           "make_join_mesh", "world_size"]

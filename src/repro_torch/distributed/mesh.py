"""The join engine's mesh over a ``torch.distributed`` world.

The JAX package lays its sharded join over a device mesh with axes
``("pod", "data", "model")``; here the devices are the ranks of a
``torch.distributed`` world (one process a rank), flattened pod-major:

    rank = (pod * n_data + data) * n_model + model

so a rank's coordinates are fixed by its rank alone, and every rank builds
the same mesh from the same arguments (SPMD).  The device count of the
reference (``len(jax.devices())``) is the world size: 1 when no process
group is initialized, in which case every collective is an exact local
equivalent (``distributed.collectives``) and no process group exists.

A ``JoinMesh`` carries, besides its shape and this rank's coordinates,
the three process groups the ring engine talks over:

  * ``inner``: the ranks of this rank's pod, over ``(data, model)`` — the
    within-pod gather of candidate counts;
  * ``cross``: the ranks that share this rank's inner index, one per pod —
    the gather of pod totals, the only collective that crosses a pod;
  * ``pull``: the whole world, to the coordinating rank (rank 0) — the
    count and eval gathers every rank decides on, and the candidate pairs
    sent to the coordinator.

``dist.new_group`` is itself a collective: every rank creates every group
(including those it is not in) in the same order, which
``make_join_mesh`` does.  A mesh must cover the world exactly: a rank
outside it would hold no shard and take no part in the collectives.
"""

from __future__ import annotations

import datetime
from typing import Optional

from repro_torch.distributed.collectives import CollectiveLedger

AXES = ("pod", "data", "model")
# a hung peer fails the collective after this long instead of hanging
GROUP_TIMEOUT = datetime.timedelta(seconds=120)


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def world_size() -> int:
    """Ranks in the default process group (1 when none is initialized)."""
    dist = _dist()
    return dist.get_world_size() if dist is not None else 1


def world_rank() -> int:
    dist = _dist()
    return dist.get_rank() if dist is not None else 0


class JoinMesh:
    """A mesh of ranks with named axes, this rank's place on it and its
    process groups (``None`` on a 1-rank world).  Compared by identity, as
    the reference's meshes are used as cache keys."""

    def __init__(self, axis_names: tuple, sizes: tuple):
        if len(axis_names) != len(sizes) or min(sizes) < 1:
            raise ValueError(f"mesh axes {axis_names} and sizes {sizes}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.size = 1
        for s in sizes:
            self.size *= int(s)
        n = world_size()
        if self.size != n:
            raise ValueError(
                f"mesh {self.shape} has {self.size} ranks but the world has "
                f"{n} devices: a mesh must cover the world exactly")
        self.rank = world_rank()
        # pod-major coordinates of this rank
        rest, coords = self.rank, {}
        for name in reversed(self.axis_names):
            coords[name] = rest % self.shape[name]
            rest //= self.shape[name]
        self.coords = {name: coords[name] for name in self.axis_names}
        self.n_pods = self.shape.get("pod", 1)
        self.n_inner = self.size // self.n_pods
        self.pod = self.coords.get("pod", 0)
        self.inner_index = self.rank % self.n_inner
        self.coordinator = 0
        self.ledger = CollectiveLedger()
        self.inner = self.cross = self.pull = None
        self.inner_ranks = [self.pod * self.n_inner + i
                            for i in range(self.n_inner)]
        self.cross_ranks = [p * self.n_inner + self.inner_index
                            for p in range(self.n_pods)]
        self.pull_ranks = list(range(self.size))
        if n > 1:
            self._make_groups()

    def _make_groups(self) -> None:
        """Every rank creates every group of more than one rank, in the
        same order; a 1-rank group stays ``None`` (its collectives are
        local)."""
        dist = _dist()

        def new_group(ranks):
            if len(ranks) == 1:
                return None
            return dist.new_group(ranks, timeout=GROUP_TIMEOUT)

        for p in range(self.n_pods):
            g = new_group([p * self.n_inner + i for i in range(self.n_inner)])
            if p == self.pod:
                self.inner = g
        if "pod" in self.axis_names:
            for i in range(self.n_inner):
                g = new_group([p * self.n_inner + i
                               for p in range(self.n_pods)])
                if i == self.inner_index:
                    self.cross = g
        self.pull = new_group(self.pull_ranks)

    @property
    def is_coordinator(self) -> bool:
        return self.rank == self.coordinator

    def group_ranks(self, kind: str) -> list:
        """World ranks of this rank's ``inner`` / ``cross`` / ``pull``
        group."""
        return {"inner": self.inner_ranks, "cross": self.cross_ranks,
                "pull": self.pull_ranks}[kind]

    def group(self, kind: str):
        return {"inner": self.inner, "cross": self.cross,
                "pull": self.pull}[kind]

    def __repr__(self) -> str:
        return (f"JoinMesh({self.shape}, rank {self.rank} at "
                f"{self.coords})")


def init_from_env(timeout: datetime.timedelta = GROUP_TIMEOUT) -> int:
    """Join the world a ``torchrun``-style launcher describes (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) over ``gloo``; without that
    environment, or with ``WORLD_SIZE`` 1, stay a world of one.  Returns
    the world size."""
    import os
    n = int(os.environ.get("WORLD_SIZE", "1"))
    if n > 1 and _dist() is None:
        import torch.distributed as dist
        dist.init_process_group("gloo", init_method="env://",
                                rank=int(os.environ["RANK"]), world_size=n,
                                timeout=timeout)
    return world_size()


def make_host_mesh() -> JoinMesh:
    """The whole world as a 1-D ``data`` mesh (no pod axis)."""
    return JoinMesh(("data", "model"), (world_size(), 1))


def make_join_mesh(n_pods: int = 1, n_data: Optional[int] = None,
                   n_model: int = 1) -> JoinMesh:
    """A 3-D ``(pod, data, model)`` mesh for the sharded join engine.

    Always carries all three axes — a degenerate ``(1, N, 1)`` request
    still has a pod axis of size 1, so the pod code path (hierarchical
    count prefix sum, per-pod band rotation) runs on any world size.
    ``n_data`` defaults to whatever divides the world evenly after pod and
    model are fixed.  Oversubscription raises ``ValueError``."""
    n = world_size()
    if n_data is None:
        n_data = n // (n_pods * n_model)
    if n_pods * n_data * n_model > n or n_data < 1:
        raise ValueError(
            f"join mesh ({n_pods}, {n_data}, {n_model}) needs "
            f"{n_pods * max(n_data, 1) * n_model} devices, have {n}")
    return JoinMesh(AXES, (n_pods, n_data, n_model))


def l_shard_axes(mesh) -> tuple:
    """Mesh axes the join engine shards L rows over: ("pod", "data") on a
    pod mesh, ("data",) otherwise."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)

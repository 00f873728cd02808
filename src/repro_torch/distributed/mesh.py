"""The meshes over a ``torch.distributed`` world: the join engine's, and
the model zoo's (the production mesh and its logical axis rules).

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

The model zoo's expert-parallel code reduces over named axes, as the
reference's ``shard_map`` bodies do (``psum(x, "model")``,
``all_gather(w, ("data", "pod"))``).  A mesh made with ``axis_groups``
(``make_mesh``, ``make_production_mesh``) also holds one process group per
set of axes and per coordinate of the other axes: ``axis_group(axes)`` is
this rank's.  Over a tuple of axes the ranks are ordered by their
flattened index, the first axis major (``axis_members``, ``axis_index``):
the reference's rule for a tuple in one entry of a ``PartitionSpec``, and
the order of its ``fi = fi * size + index`` loop.  ``env.fsdp`` is
``("data", "pod")``, data-major, while the world's ranks are pod-major.

Logical dimension names resolve to mesh axes by ``AxisEnv``, as in the
reference:

  batch   — activation batch dim           -> ("pod", "data")
  fsdp    — weight dim sharded ZeRO-3 style -> ("data", "pod")
  tp      — tensor-parallel weight/act dim -> ("model",)
  sp      — sequence dim of saved activations -> ("model",)
  expert  — MoE expert dim                  -> ("model",)
  (None)  — replicated

A ``Spec`` (one entry a dim: ``None``, an axis, or a tuple of axes) is the
port's ``PartitionSpec``; ``shard_leaf`` gives this rank's block of a
tensor under one, ``unshard_leaf`` the whole tensor back from the blocks.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
from typing import Optional, Sequence

from repro_torch.distributed.collectives import AxisLedger, CollectiveLedger

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
    the reference's meshes are used as cache keys.  With ``axis_groups``
    it also creates a group for every set of its axes (``axis_group``), so
    a 16-rank (2, 4, 2) world creates 28 more groups: only the model zoo's
    meshes ask for them."""

    def __init__(self, axis_names: tuple, sizes: tuple, *,
                 axis_groups: bool = False):
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
        self.coords = self._coords_of(self.rank)      # pod-major
        self.n_pods = self.shape.get("pod", 1)
        self.n_inner = self.size // self.n_pods
        self.pod = self.coords.get("pod", 0)
        self.inner_index = self.rank % self.n_inner
        self.coordinator = 0
        self.ledger = CollectiveLedger()
        self.axis_ledger = AxisLedger()
        self._axis_groups: dict = {}
        self.inner = self.cross = self.pull = None
        self.inner_ranks = [self.pod * self.n_inner + i
                            for i in range(self.n_inner)]
        self.cross_ranks = [p * self.n_inner + self.inner_index
                            for p in range(self.n_pods)]
        self.pull_ranks = list(range(self.size))
        if n > 1:
            self._make_groups()
            if axis_groups:
                self._make_axis_groups()

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

    def _make_axis_groups(self) -> None:
        """One group per non-empty set of axes and per coordinate of the
        other axes, every rank creating every group in the same order
        (sets in ``itertools.combinations`` order, then groups by their
        lowest rank)."""
        dist = _dist()
        for k in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                parts: dict = {}
                for r in range(self.size):
                    c = self._coords_of(r)
                    key = tuple(c[a] for a in self.axis_names
                                if a not in axes)
                    parts.setdefault(key, []).append(r)
                for ranks in parts.values():
                    g = (dist.new_group(ranks, timeout=GROUP_TIMEOUT)
                         if len(ranks) > 1 else None)
                    if self.rank in ranks:
                        self._axis_groups[frozenset(axes)] = g

    def _coords_of(self, rank: int) -> dict:
        """A rank's coordinates, the first axis major."""
        rest, coords = rank, {}
        for name in reversed(self.axis_names):
            coords[name] = rest % self.shape[name]
            rest //= self.shape[name]
        return {name: coords[name] for name in self.axis_names}

    def _rank_of(self, coords: dict) -> int:
        r = 0
        for name in self.axis_names:
            r = r * self.shape[name] + coords[name]
        return r

    def axis_size(self, axes: Sequence[str]) -> int:
        """Ranks along ``axes`` (an axis the mesh lacks counts 1)."""
        return axis_size(self, tuple(axes))

    def axis_index(self, axes: Sequence[str]) -> int:
        """This rank's flattened index over ``axes``, the first major."""
        i = 0
        for a in axes:
            i = i * self.shape.get(a, 1) + self.coords.get(a, 0)
        return i

    def axis_members(self, axes: Sequence[str]) -> list:
        """The world ranks that share this rank's coordinates off ``axes``,
        in flattened-index order over ``axes`` (the first axis major)."""
        axes = [a for a in axes if a in self.shape]
        out = []
        for idx in itertools.product(*(range(self.shape[a]) for a in axes)):
            c = dict(self.coords)
            c.update(zip(axes, idx))
            out.append(self._rank_of(c))
        return out

    def axis_group(self, axes: Sequence[str]):
        """This rank's process group over ``axes``: ``None`` when it has
        one rank.  The mesh must have been made with ``axis_groups``."""
        if self.axis_size(axes) == 1:
            return None
        key = frozenset(a for a in axes if a in self.shape)
        if key not in self._axis_groups:
            raise ValueError(f"{self!r} has no process group over {sorted(key)}:"
                             f" make it with axis_groups=True")
        return self._axis_groups[key]

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


# ---------------------------------------------------------------------------
# the model zoo's mesh: production shapes, logical axis rules, specs
# ---------------------------------------------------------------------------

def make_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> JoinMesh:
    """A mesh of ``shape`` over ``axis_names`` covering the world, with a
    process group per set of axes (``jax.make_mesh``'s counterpart for the
    model zoo).  A world of another size raises ``ValueError``."""
    return JoinMesh(tuple(axis_names), tuple(shape), axis_groups=True)


def make_production_mesh(*, multi_pod: bool = False) -> JoinMesh:
    """The production mesh: (16, 16) over ("data", "model"), one pod of
    256 ranks; or (2, 16, 16) over ("pod", "data", "model").  The world
    must have exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    n = world_size()
    if n != need:
        raise ValueError(f"the production mesh {shape} over {axes} needs a "
                         f"world of {need} ranks, have {n}")
    return make_mesh(shape, axes)


class Spec(tuple):
    """A partition spec: one entry a dim, ``None`` (replicated), an axis
    name, or a tuple of axis names (sharded over their flattened index,
    the first major).  Compares equal to the tuple of its entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"

    def axes(self, dim: int) -> tuple:
        """The axes dim ``dim`` is sharded over (``()`` if replicated)."""
        e = self[dim] if dim < len(self) else None
        return () if e is None else (e,) if isinstance(e, str) else tuple(e)

    def all_axes(self) -> tuple:
        return tuple(a for d in range(len(self)) for a in self.axes(d))


@dataclasses.dataclass(frozen=True)
class AxisEnv:
    """Resolved mesh-axis assignments for the logical names."""
    batch: tuple
    fsdp: tuple
    tp: tuple
    sp: tuple
    expert: tuple

    @staticmethod
    def from_mesh(mesh) -> "AxisEnv":
        """From anything with ``axis_names`` (a ``JoinMesh``)."""
        names = set(mesh.axis_names)
        data = ("data",) if "data" in names else ()
        pod = ("pod",) if "pod" in names else ()
        model = ("model",) if "model" in names else ()
        return AxisEnv(batch=pod + data, fsdp=data + pod, tp=model, sp=model,
                       expert=model)

    def resolve(self, logical: Sequence[Optional[str]]) -> Spec:
        """Map a tuple of logical dim names to a ``Spec``."""
        out = []
        for name in logical:
            axes = () if name is None else getattr(self, name)
            out.append(None if not axes else axes[0] if len(axes) == 1
                       else tuple(axes))
        return Spec(*out)


def axis_size(mesh, names: tuple) -> int:
    n = 1
    for name in names:
        n *= mesh.shape.get(name, 1)
    return n


def batch_spec(env: AxisEnv, mesh, global_batch: int) -> Optional[str]:
    """'batch' if the batch dim divides the batch mesh axes, else None
    (a global batch of 1 is replicated rather than padded)."""
    ways = axis_size(mesh, env.batch)
    return "batch" if global_batch % ways == 0 and global_batch >= ways else None


def _block(mesh, shape, spec: Spec) -> tuple:
    """This rank's slice of each dim under ``spec``."""
    out = []
    for dim, n in enumerate(shape):
        axes = spec.axes(dim)
        ways = axis_size(mesh, axes)
        if n % ways:
            raise ValueError(f"dim {dim} of size {n} does not split over "
                             f"{axes} ({ways} ways)")
        step = n // ways
        i = mesh.axis_index(axes) if axes else 0
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out)


def block_shape(mesh, shape, spec: Spec) -> tuple:
    """The shape of this rank's block of a ``shape`` tensor under
    ``spec``."""
    return tuple(sl.stop - sl.start
                 for sl in _block(mesh, tuple(shape), Spec(*spec)))


def block_slices(mesh, shape, spec: Spec) -> tuple:
    """This rank's slice of each dim of a ``shape`` tensor under
    ``spec``."""
    return _block(mesh, tuple(shape), Spec(*spec))


def shard_leaf(mesh, x, spec: Spec):
    """This rank's block of ``x`` under ``spec``: a view where the spec
    shards nothing, else a contiguous copy (so the whole ``x`` can be
    freed).  Every sharded dim must divide evenly."""
    spec = Spec(*spec)
    sl = _block(mesh, tuple(x.shape), spec)
    if not spec.all_axes():
        return x
    return x[sl].contiguous()


def unshard_leaf(mesh, block, spec: Spec):
    """The whole tensor from every rank's ``block`` under ``spec`` (all
    ranks call it; all-gathers over each sharded dim's axes)."""
    from repro_torch.distributed import collectives
    spec = Spec(*spec)
    for dim in range(block.ndim):
        axes = spec.axes(dim)
        if axes:
            block = collectives.axis_all_gather(block, mesh, axes, dim,
                                               "checkpoint")
    return block

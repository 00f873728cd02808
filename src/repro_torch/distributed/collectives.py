"""Every ``torch.distributed`` call of the join engine and of the model
mesh, each with a byte ledger.

The JAX package checks what crosses a pod by parsing the compiled
program's collectives (``distributed/hlo_analysis.py``
``pod_crossing_stats``).  Here the engine's collectives are calls made on
the host, so they are counted as they are made: each goes through this
module, which records its bytes by the kind of group it ran over —

  * ``inner``: within a pod (the gather of candidate counts);
  * ``cross``: across pods (the gather of pod totals);
  * ``pull``:  the world, to the coordinating rank (count and eval
    gathers, and the candidate pairs sent to the coordinator).

The invariant the dry-run gates on (``check_counts_only``):

  * planes and masks never enter a collective: every payload is int32,
    tagged ``counts`` or ``pairs``;
  * across pods, a call carries int32 counts only: one int32 a rank of
    the group;
  * candidate pairs travel once, to the coordinating rank, over the pull
    group, 8 B a pair.

Counts travel as int32 host tensors over ``gloo``: they are on the host
anyway once a band step's 8-byte counter pull lands, and gloo lets several
ranks share one card (NCCL refuses that).  On a group of one rank — every
group of a 1-rank world — a call is its exact local equivalent and is
recorded all the same, so a 1-rank world runs the same code.

The model mesh's collectives (the expert-parallel MoE, ``models/moe.py``)
are the reference's ``shard_map`` collectives over named axes:
``all_to_all`` (tiled, split and concatenated on dim 0), ``psum``,
``pmean``, a tiled ``all_gather`` and its transpose, the reduce-scatter.
Each is a ``torch.autograd.Function`` with its backward beside it.  The
backward passes treat every rank as a device of its own, each holding its
own copy of what is replicated: a ``psum``'s cotangent is summed again, an
``all_gather``'s is reduce-scattered, an ``all_to_all`` is its own
transpose; an output held by ``c`` ranks gives each copy ``1/c`` of its
cotangent (``gather_out``, ``replicated``); a replicated input sums its
copies' cotangents over the axes it is replicated on (``pvary``,
``shard_in``).  That is the gradient of the whole SPMD program, which is
what ``jax.grad`` through the reference's ``shard_map`` computes.

Routes: gloo runs ``all_reduce`` on CUDA tensors (``"gloo"``) but neither
``all_gather`` nor ``all_to_all``: those stage a CUDA tensor through the
host here, explicitly (``"host"``; a CPU tensor goes to gloo as it is).
Gloo has no reduce-scatter on every torch version either: it is an
``all_reduce`` and a slice, and books the ``all_reduce``'s bytes.  The
``AxisLedger`` books calls and bytes by axis label (``model``, ``fsdp``,
``batch``, ...), op and route; a call over one rank moves nothing and is
not booked.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

GROUP_KINDS = ("inner", "cross", "pull")
PAYLOADS = ("counts", "pairs")
ROUTES = ("gloo", "host")


class CollectiveLedger:
    """Calls and bytes of a mesh's collectives, by (group kind, op,
    payload, ranks in the group).  Aggregated, not logged: a serving
    process makes calls for as long as it runs."""

    def __init__(self):
        self._lock = threading.Lock()   # fleet workers share the host mesh
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._rows: dict = {}

    def record(self, kind: str, op: str, payload: str, nbytes: int,
               ranks: int) -> None:
        """One call: ``nbytes`` moved (a gather's whole result; the bytes
        a point-to-point call sends), ``ranks`` in its group."""
        if kind not in GROUP_KINDS or payload not in PAYLOADS:
            raise ValueError(f"collective over {kind!r} with payload "
                             f"{payload!r}")
        with self._lock:
            row = self._rows.setdefault(
                (kind, op, payload, int(ranks)),
                {"calls": 0, "bytes": 0, "max_call_bytes": 0})
            row["calls"] += 1
            row["bytes"] += int(nbytes)
            row["max_call_bytes"] = max(row["max_call_bytes"], int(nbytes))

    def summary(self) -> dict:
        """By group kind: calls, bytes, largest call, widest group; by
        payload: bytes; ``cross_pod_calls``: calls over a cross group of
        more than one rank (those that cross a pod boundary)."""
        with self._lock:
            rows = {k: dict(v) for k, v in self._rows.items()}
        by_group = {k: {"calls": 0, "bytes": 0, "max_call_bytes": 0,
                        "ranks": 0} for k in GROUP_KINDS}
        by_payload = {p: 0 for p in PAYLOADS}
        cross_calls = 0
        for (kind, _op, payload, ranks), r in rows.items():
            g = by_group[kind]
            g["calls"] += r["calls"]
            g["bytes"] += r["bytes"]
            g["max_call_bytes"] = max(g["max_call_bytes"],
                                      r["max_call_bytes"])
            g["ranks"] = max(g["ranks"], ranks)
            by_payload[payload] += r["bytes"]
            if kind == "cross" and ranks > 1:
                cross_calls += r["calls"]
        return {"by_group": by_group, "by_payload": by_payload,
                "cross_pod_calls": cross_calls,
                "max_cross_call_bytes": by_group["cross"]["max_call_bytes"],
                # one int32 count a rank of the group
                "cross_call_budget_bytes": 4 * by_group["cross"]["ranks"],
                "pairs_outside_pull": sum(
                    r["bytes"] for (kind, _o, p, _n), r in rows.items()
                    if p == "pairs" and kind != "pull"),
                "ops": sorted({f"{k}:{o}:{p}" for k, o, p, _n in rows})}


def check_counts_only(summary: dict) -> list:
    """Findings (strings; empty = the invariant holds) for a ledger
    summary: cross-pod calls count-sized and pairs only over the pull
    group.  (Planes cannot enter: payloads are int32 by ``_int32``; a pair
    is 2 int32 by ``send_pairs`` / ``recv_pairs``.)"""
    out = []
    if summary["max_cross_call_bytes"] > summary["cross_call_budget_bytes"]:
        out.append(f"a cross-pod call moved {summary['max_cross_call_bytes']}"
                   f" B, over the {summary['cross_call_budget_bytes']} B of "
                   f"one int32 a rank")
    if summary["pairs_outside_pull"]:
        out.append(f"{summary['pairs_outside_pull']} B of pairs outside the "
                   f"pull group")
    return out


def _int32(values) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(values))
    if t.dtype != torch.int32:
        # planes (f32) and anything else stay out of collectives
        raise TypeError(f"collective payloads are int32, got {t.dtype}")
    return t.reshape(-1).contiguous()


def all_gather(values, mesh, kind: str) -> np.ndarray:
    """All-gather int32 ``values`` (one per field) over this rank's
    ``kind`` group; returns int32 (group ranks, fields), in group rank
    order."""
    t = _int32(values)
    ranks = mesh.group_ranks(kind)
    group = mesh.group(kind)
    if group is None:                  # a 1-rank group: the local copy
        out = t.numpy().reshape(1, -1).copy()
    else:
        import torch.distributed as dist
        parts = [torch.empty_like(t) for _ in ranks]
        dist.all_gather(parts, t, group=group)
        out = torch.stack(parts).numpy()
    mesh.ledger.record(kind, "all_gather", "counts", out.nbytes, len(ranks))
    return out


def send_pairs(pairs: np.ndarray, mesh) -> None:
    """Send this rank's (n, 2) int32 candidate pairs to the coordinator
    over the pull group (n is known there from the gathered counts).  The
    sender records what it sent, the coordinator what it received."""
    import torch.distributed as dist
    t = _int32(pairs)
    dist.send(t, dst=mesh.coordinator, group=mesh.pull)
    mesh.ledger.record("pull", "send", "pairs", t.numel() * 4,
                       len(mesh.pull_ranks))


def recv_pairs(n: int, src: int, mesh) -> np.ndarray:
    """Receive rank ``src``'s ``n`` candidate pairs on the coordinator."""
    import torch.distributed as dist
    t = torch.empty(2 * n, dtype=torch.int32)
    dist.recv(t, src=src, group=mesh.pull)
    mesh.ledger.record("pull", "recv", "pairs", t.numel() * 4,
                       len(mesh.pull_ranks))
    return t.numpy().reshape(n, 2)


# ---------------------------------------------------------------------------
# the model mesh
# ---------------------------------------------------------------------------

class AxisLedger:
    """Calls and bytes of the model mesh's collectives by (axis label, op,
    route, ranks in the group)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._rows: dict = {}

    def record(self, axis: str, op: str, route: str, nbytes: int,
               ranks: int) -> None:
        if route not in ROUTES:
            raise ValueError(f"route {route!r}")
        with self._lock:
            row = self._rows.setdefault((axis, op, route, int(ranks)),
                                        {"calls": 0, "bytes": 0})
            row["calls"] += 1
            row["bytes"] += int(nbytes)

    def summary(self) -> dict:
        """Calls and bytes by axis label and by route, and every row."""
        with self._lock:
            rows = {k: dict(v) for k, v in self._rows.items()}
        by_axis, by_route = {}, {r: {"calls": 0, "bytes": 0} for r in ROUTES}
        for (axis, _op, route, _n), r in rows.items():
            a = by_axis.setdefault(axis, {"calls": 0, "bytes": 0})
            for d in (a, by_route[route]):
                d["calls"] += r["calls"]
                d["bytes"] += r["bytes"]
        return {"by_axis": by_axis, "by_route": by_route,
                "rows": [dict(axis=k[0], op=k[1], route=k[2], ranks=k[3], **v)
                         for k, v in sorted(rows.items())]}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group(mesh, axes):
    """(process group or None, this rank's members in flattened order,
    their positions in the group's rank order)."""
    members = mesh.axis_members(axes)
    group = mesh.axis_group(axes) if len(members) > 1 else None
    order = sorted(members)
    return group, members, [order.index(m) for m in members]


def axis_all_reduce(x: torch.Tensor, mesh, axes, label: str) -> torch.Tensor:
    """The sum of ``x`` over ``axes`` (a new tensor; ``x`` is kept).  A
    CUDA tensor goes to gloo on the card."""
    group, members, _ = _group(mesh, axes)
    if group is None:
        return x.clone()
    import torch.distributed as dist
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    mesh.axis_ledger.record(label, "all_reduce", "gloo", _nbytes(out),
                            len(members))
    return out


def _stage(x: torch.Tensor):
    return (x.cpu(), "host") if x.is_cuda else (x, "gloo")


def axis_all_gather(x: torch.Tensor, mesh, axes, dim: int, label: str
               ) -> torch.Tensor:
    """Every member's ``x`` concatenated on ``dim`` in flattened-index
    order over ``axes`` (tiled)."""
    group, members, pos = _group(mesh, axes)
    if group is None:
        return x
    import torch.distributed as dist
    h, route = _stage(x.contiguous())
    parts = [torch.empty_like(h) for _ in members]
    dist.all_gather(parts, h, group=group)
    out = torch.cat([parts[p] for p in pos], dim=dim).to(x.device)
    mesh.axis_ledger.record(label, "all_gather", route, _nbytes(out),
                            len(members))
    return out


def axis_all_to_all(x: torch.Tensor, mesh, axes, label: str) -> torch.Tensor:
    """Tiled all-to-all on dim 0: ``x``'s j-th chunk goes to the j-th
    member (flattened order), and the result's j-th chunk came from it."""
    group, members, pos = _group(mesh, axes)
    if group is None:
        return x
    import torch.distributed as dist
    n = len(members)
    h, route = _stage(x.contiguous())
    chunks = list(h.chunk(n))
    send = [None] * n
    for j, p in enumerate(pos):              # group rank p is member j
        send[p] = chunks[j]
    send = torch.cat(send)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    got = list(recv.chunk(n))
    out = torch.cat([got[p] for p in pos]).to(x.device)
    mesh.axis_ledger.record(label, "all_to_all", route, _nbytes(send), n)
    return out


def axis_reduce_scatter(x: torch.Tensor, mesh, axes, dim: int, label: str
                   ) -> torch.Tensor:
    """The sum over ``axes`` of ``x``, this rank's tile of it on ``dim``:
    an ``all_reduce`` and a slice (gloo lacks the op on some versions),
    booked as a reduce-scatter with the ``all_reduce``'s bytes."""
    group, members, _ = _group(mesh, axes)
    if group is None:
        return x
    import torch.distributed as dist
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    mesh.axis_ledger.record(label, "reduce_scatter", "gloo", _nbytes(out),
                            len(members))
    n = len(members)
    step = out.shape[dim] // n
    i = mesh.axis_index(axes)
    return out.narrow(dim, i * step, step).contiguous()


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, label, scale):
        ctx.args = (mesh, axes, label, scale)
        out = axis_all_reduce(x, mesh, axes, label)
        return out if scale == 1 else out / scale

    @staticmethod
    def backward(ctx, g):
        mesh, axes, label, scale = ctx.args
        out = axis_all_reduce(g, mesh, axes, label)
        return (out if scale == 1 else out / scale), None, None, None, None


def psum(x, mesh, axes, label: str):
    """``lax.psum``: the sum over ``axes``; its cotangent is summed too."""
    if mesh.axis_size(axes) == 1:
        return x
    return _PSum.apply(x, mesh, tuple(axes), label, 1)


def pmean(x, mesh, axes, label: str):
    """``lax.pmean``: the mean over ``axes`` (the sum, then a division by
    the rank count); its cotangent likewise."""
    if mesh.axis_size(axes) == 1:
        return x
    return _PSum.apply(x, mesh, tuple(axes), label, mesh.axis_size(axes))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, label):
        ctx.args = (mesh, axes, dim, label)
        return axis_all_gather(x, mesh, axes, dim, label)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim, label = ctx.args
        return axis_reduce_scatter(g, mesh, axes, dim, label), None, None, None, None


def gather(x, mesh, axes, dim: int, label: str):
    """``lax.all_gather(x, axes, axis=dim, tiled=True)`` over a tuple of
    axes at once; the backward is the reduce-scatter."""
    if mesh.axis_size(axes) == 1:
        return x
    return _AllGather.apply(x, mesh, tuple(axes), dim, label)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, label):
        ctx.args = (mesh, axes, label)
        return axis_all_to_all(x, mesh, axes, label)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, label = ctx.args
        return axis_all_to_all(g, mesh, axes, label), None, None, None


def alltoall(x, mesh, axes, label: str):
    """``lax.all_to_all(x, axes, 0, 0, tiled=True)``; its own transpose."""
    if mesh.axis_size(axes) == 1:
        return x
    return _AllToAll.apply(x, mesh, tuple(axes), label)


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, label):
        ctx.args = (mesh, axes, label)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, label = ctx.args
        return axis_all_reduce(g, mesh, axes, label), None, None, None


def pvary(x, mesh, axes, label: str):
    """The identity, where ``x`` is replicated over ``axes``: each copy's
    cotangent is summed over them (``lax.pvary``'s transpose)."""
    axes = tuple(axes)
    if mesh.axis_size(axes) == 1:
        return x
    return _PVary.apply(x, mesh, axes, label)


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, copies):
        ctx.copies = copies
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.copies, None


def replicated(x, copies: int):
    """The identity, for a value held by ``copies`` ranks that the code
    after it uses once: each copy takes ``1/copies`` of the cotangent."""
    return x if copies == 1 else _Replicated.apply(x, copies)


def _spec_axes(spec) -> tuple:
    return tuple(a for e in spec if e is not None
                 for a in ((e,) if isinstance(e, str) else e))


class _ShardIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, spec, labels):
        from repro_torch.distributed.mesh import shard_leaf
        ctx.args = (mesh, spec, labels)
        out = shard_leaf(mesh, x, spec)
        return out.view_as(out) if out is x else out

    @staticmethod
    def backward(ctx, g):
        mesh, spec, labels = ctx.args
        for dim, e in enumerate(spec):
            if e is not None:
                axes = (e,) if isinstance(e, str) else tuple(e)
                g = axis_all_gather(g, mesh, axes, dim, labels[dim])
        rest = tuple(a for a in mesh.axis_names if a not in _spec_axes(spec))
        g = axis_all_reduce(g, mesh, rest, labels[-1]) if rest else g
        return g, None, None, None


def shard_in(x, mesh, spec, labels):
    """This rank's block of the replicated ``x`` under ``spec`` (a
    ``shard_map`` input); the backward assembles the blocks' cotangents
    (an all-gather a sharded dim, ``labels[dim]``) and sums the copies
    over the axes the spec leaves out (``labels[-1]``)."""
    if mesh.size == 1:
        return x
    return _ShardIn.apply(x, mesh, tuple(spec), tuple(labels))


class _GatherOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, spec, labels, copies):
        ctx.args = (mesh, spec, copies)
        for dim, e in enumerate(spec):
            if e is not None:
                axes = (e,) if isinstance(e, str) else tuple(e)
                x = axis_all_gather(x, mesh, axes, dim, labels[dim])
        return x

    @staticmethod
    def backward(ctx, g):
        from repro_torch.distributed.mesh import shard_leaf
        mesh, spec, copies = ctx.args
        g = shard_leaf(mesh, g, spec)
        return (g if copies == 1 else g / copies), None, None, None, None


def gather_out(x, mesh, spec, labels):
    """The whole tensor from every rank's block under ``spec`` (a
    ``shard_map`` output, made replicated); the backward takes this rank's
    block of the cotangent, shared among the ranks that hold the same
    block."""
    spec = tuple(spec)
    copies = mesh.size // mesh.axis_size(_spec_axes(spec))
    if copies == mesh.size:
        return replicated(x, copies)
    return _GatherOut.apply(x, mesh, spec, tuple(labels), copies)


def _label(axes) -> str:
    return "+".join(axes) if axes else "local"


def _tree_zip(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _tree_zip(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not hasattr(specs, "axes"):
        return type(tree)(_tree_zip(fn, t, s) for t, s in zip(tree, specs))
    return fn(tree, specs)


def shard_map(fn, mesh, in_specs, out_specs):
    """``jax.shard_map`` over whole (replicated) inputs: each input (a
    tensor or a dict of them) is sliced to this rank's block by its spec
    (``shard_in``), ``fn`` runs on the blocks, and each output is gathered
    back whole by its spec (``gather_out``); a ``Spec()`` output must be
    the same on every rank.  Collectives are booked under the axes they
    run over."""
    def lab(spec):
        return tuple(_label(spec.axes(d)) for d in range(len(spec))) + (
            "replicas",)

    def run(*args):
        local = [_tree_zip(lambda a, s: shard_in(a, mesh, s, lab(s)), a, s)
                 for a, s in zip(args, in_specs)]
        outs = fn(*local)
        return _tree_zip(lambda o, s: gather_out(o, mesh, s, lab(s)), outs,
                         out_specs)
    return run
